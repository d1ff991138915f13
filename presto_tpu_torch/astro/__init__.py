"""astro layer of the PyTorch port (mirrors presto_tpu/astro): the time
scales and the observatory table the TOA lines need.  Barycentring and
polycos come in a later slice."""
