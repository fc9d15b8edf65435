from .nuwa import NUWA
from .nuwa_sketch import NUWASketch
from .nuwa_video_audio import NUWAVideoAudio

__all__ = ["NUWA", "NUWASketch", "NUWAVideoAudio"]
