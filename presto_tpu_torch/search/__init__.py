"""search layer of the PyTorch port (mirrors presto_tpu/search)."""
