"""Model code of the port (dense decoder blocks in this slice)."""
