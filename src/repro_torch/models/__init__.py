"""Model layers and the decoder LM."""
