"""Host-side helpers: image grids and their PNG files."""
