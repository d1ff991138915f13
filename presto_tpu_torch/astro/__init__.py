"""astro layer of the PyTorch port (mirrors presto_tpu/astro): time
scales, the observatory table, the solar-system ephemerides (EPV2000,
tables, JPL SPK kernels read and written), barycentring, binary orbits
(binary) and TEMPO-free polycos (polycos)."""
