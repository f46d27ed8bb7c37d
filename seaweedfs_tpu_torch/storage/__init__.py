"""Storage formats of the port: needles, superblock, .idx, the volume append path."""
