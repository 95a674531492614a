"""Hardware tables for the roofline terms (the mesh factories are not ported)."""
