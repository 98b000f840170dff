"""The semi-supervised algorithm: PASA bias, pseudo-labels, mixes, NCR,
EMA and the S4Former training step."""
