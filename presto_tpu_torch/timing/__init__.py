"""Pulse timing: template matching (FFTFIT) and TOA extraction.

The reference implements this as the f2py-wrapped Fortran fftfit
(python/fftfit_src/*.f, Taylor 1992) driven by bin/get_TOAs.py; here it
is a NumPy reimplementation of the same algorithm (the PyTorch port's
copy of presto_tpu/timing).
"""

from presto_tpu_torch.timing.fftfit import (FFTFitResult, fftfit,
                                           gaussian_template)
from presto_tpu_torch.timing.toas import (TOA, format_princeton,
                                         format_tempo2, toas_from_pfd)

__all__ = ["FFTFitResult", "fftfit", "gaussian_template", "TOA",
           "toas_from_pfd", "format_princeton", "format_tempo2"]
