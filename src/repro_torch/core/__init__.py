"""Front end, quantization, stage program and synthesis flow."""
