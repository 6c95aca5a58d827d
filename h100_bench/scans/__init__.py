"""The traffic's scan kinds, one file each, found by ``gen.scan_kind``."""
