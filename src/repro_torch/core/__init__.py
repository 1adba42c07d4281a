"""Arena geometry, the HotMem manager and the elastic device arena."""
