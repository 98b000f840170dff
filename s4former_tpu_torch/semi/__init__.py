"""Semi-supervised pieces: the PASA attention bias."""
