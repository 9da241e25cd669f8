"""Entry points: the LM serving loop."""
