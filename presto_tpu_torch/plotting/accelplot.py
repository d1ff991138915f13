"""F-Fdot plane visualization for accelsearch candidates.

The reference has no direct equivalent (its explorers are interactive
PGPLOT TUIs, deferred per SURVEY.md §7.4); this renders the power plane
around a candidate with the harmonic track marked — the standard
diagnostic for acceleration-search follow-up.

Host copy of ``presto_tpu/plotting/accelplot.py`` for the PyTorch port,
which imports nothing from the JAX package; drawing needs matplotlib
(``plotting.pyplot``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def plot_ffdot(powers: np.ndarray, rs: np.ndarray, zs: np.ndarray,
               outfile: str, cands: Optional[Sequence] = None,
               title: str = "") -> str:
    """powers: [numz, numr] plane; rs/zs: axis coordinates (Fourier
    bins / z bins); cands: objects with .r and .z attributes."""
    from presto_tpu_torch.plotting import pyplot
    plt = pyplot("the F-Fdot plane plot")

    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(np.asarray(powers, float), aspect="auto",
                   origin="lower", cmap="viridis",
                   extent=[rs[0], rs[-1], zs[0], zs[-1]])
    fig.colorbar(im, ax=ax, label="Normalized power")
    if cands:
        ax.plot([c.r for c in cands], [c.z for c in cands], "rx",
                ms=8, mew=1.5)
    ax.set_xlabel("Fourier frequency r (bins)")
    ax.set_ylabel("Fourier f-dot z (bins)")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(outfile, dpi=100)
    plt.close(fig)
    return outfile
