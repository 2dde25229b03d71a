"""Source-side IO: the double-buffered corpus reader."""
