"""utils of the PyTorch port (see the matching dnascent_tpu module)."""
