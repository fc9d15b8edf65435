"""Host-side helpers: image grids and their PNG files, int8 serving
weights, tracing and step timing (``profiling``, ``timing``)."""
