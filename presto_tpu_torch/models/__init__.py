"""models layer of the PyTorch port (mirrors presto_tpu/models)."""
