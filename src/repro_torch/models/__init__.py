"""Model stack: layers, attention, blocks and the decoder-only LM."""
