"""testing layer of the PyTorch port (mirrors presto_tpu/testing)."""
