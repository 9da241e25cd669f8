"""Entry points: the LM serving loop, the training driver, the paper's
verifier and autotune, and the stage-timed profile."""
