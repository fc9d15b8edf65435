from .loader import gather_i64, gather_normalize_f32, rot90_f32

__all__ = ["gather_normalize_f32", "rot90_f32", "gather_i64"]
