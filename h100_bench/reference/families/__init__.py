"""The reference's families, one file each, found by ``nets.family``."""
