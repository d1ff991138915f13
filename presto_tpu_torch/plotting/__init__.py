"""Diagnostic plotting (matplotlib replaces the reference's PGPLOT).

PyTorch counterpart of ``presto_tpu/plotting/__init__.py``.  The
reference renders its diagnostics in C against PGPLOT
(src/prepfold_plot.c, src/rfifind_plot.c, xyline.c/powerplot.c) and in
Python via ppgplot (single-pulse plots, sp_pgplot.py).  Every entry
point here takes data objects (Pfd, RfifindResult, SpdData, event lists)
and writes a PNG/PS file, headless (Agg).

Importing the package does not import matplotlib: the numbers behind a
panel (pfdplot.pfd_panels) are computed where matplotlib is missing, as
on a machine that only has the card.  Drawing calls ``pyplot()``, which
raises ImportError naming matplotlib there; nothing skips a plot.
"""


def pyplot(what: str = "the plot"):
    """matplotlib.pyplot on the headless Agg backend; ImportError naming
    matplotlib and ``what`` when it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "%s needs matplotlib, which is not installed (%s)"
            % (what, e)) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


from presto_tpu_torch.plotting.pfdplot import plot_pfd          # noqa: E402
from presto_tpu_torch.plotting.rfiplot import plot_rfifind      # noqa: E402
from presto_tpu_torch.plotting.spplot import (plot_spd,         # noqa: E402
                                              plot_singlepulse)
from presto_tpu_torch.plotting.accelplot import plot_ffdot      # noqa: E402

__all__ = ["plot_pfd", "plot_rfifind", "plot_spd",
           "plot_singlepulse", "plot_ffdot", "pyplot"]
