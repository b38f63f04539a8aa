"""FuSeConv operator math and operator IR."""
