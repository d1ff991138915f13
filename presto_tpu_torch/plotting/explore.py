"""explorefft/exploredat view logic + matplotlib rendering.

The reference ships PGPLOT-based interactive browsers
(src/explorefft.c:1-1030, src/exploredat.c:1-744): a power spectrum /
time series is displayed at most DISPLAYNUM=1024 points per screen by
taking the max (spectrum) or min/avg/max (series) over chunks, with
keyboard zoom/pan, median normalization, and harmonic markers.  This
module rebuilds that as a pure-logic view class (testable headless)
plus matplotlib rendering; the apps attach key bindings when an
interactive backend is available and write a PNG otherwise.

Host copy of ``presto_tpu/plotting/explore.py`` for the PyTorch port,
which imports nothing from the JAX package: the views are NumPy logic,
and rendering needs matplotlib (``plotting.pyplot``, the headless Agg
backend, so run_explorer writes a PNG as the JAX package's does).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

DISPLAYNUM = 1024               # max points on screen (explorefft.c:25)
LOCALCHUNK = 16                 # chunk for local-median norm (:26)


def _chunks_of(x: np.ndarray, nchunks: int):
    """x padded (last value) and reshaped to [nchunks, csize] — the
    one source of the tail-padding convention."""
    n = len(x)
    csize = -(-n // nchunks)
    pad = csize * nchunks - n
    if pad:
        x = np.concatenate([x, np.full(pad, x[-1], x.dtype)])
    return x.reshape(nchunks, csize), csize


def _chunk_reduce(x: np.ndarray, nout: int, how: str) -> np.ndarray:
    """Reduce x to nout display points chunk-wise (pads the tail)."""
    if len(x) <= nout:
        return x
    c, _ = _chunks_of(x, nout)
    if how == "max":
        return c.max(axis=1)
    if how == "min":
        return c.min(axis=1)
    return c.mean(axis=1)


@dataclass
class _WindowedView:
    """Shared zoom/pan/clamp navigation over a 1-D array window."""

    def _n(self) -> int:
        return len(self._array())

    def _clamp(self, default_bins: int) -> None:
        n = self._n()
        if self.numbins <= 0:
            self.numbins = min(n, default_bins)
        self.numbins = max(32, min(self.numbins, n))
        self.lobin = int(max(0, min(self.lobin, n - self.numbins)))

    def zoom(self, factor: float) -> None:
        """factor > 1 zooms out (more bins), < 1 in; recenters."""
        n = self._n()
        center = self.lobin + self.numbins // 2
        newnum = int(max(32, min(n, self.numbins * factor)))
        self.lobin = max(0, min(center - newnum // 2, n - newnum))
        self.numbins = newnum

    def pan(self, frac: float) -> None:
        """Shift the window by frac of its width (+right / -left)."""
        n = self._n()
        self.lobin = int(max(0, min(self.lobin + frac * self.numbins,
                                    n - self.numbins)))


@dataclass
class SpectrumView(_WindowedView):
    """Windowed view of a packed .fft power spectrum.

    Mirrors explorefft's display model: median-normalized powers
    (local LOCALCHUNK medians, like the reference's chunked polynomial
    fit), chunk-max display reduction, power-of-two zoom, harmonic
    markers, switchable normalization (explorefft.c:912-958) and a
    birdie zaplist sink (explorefft.c:810-885).
    """
    powers: np.ndarray            # raw |X|^2, k = 0..n/2-1
    T: float                      # observation length (s)
    lobin: int = 0
    numbins: int = 0              # 0 -> initial window (2^17 like ref)
    harmonics: int = 0            # draw markers at k*f0 for cursor f0
    cursor_r: float = 0.0
    norm_mode: str = "median"     # 'median' | 'raw' ('N' key cycle)
    yscale: float = 0.0           # manual y ceiling; 0 = auto ('S')
    zapfile: str = "explore.zap"  # 'Z' appends birdies here
    zapped: List[Tuple[float, float]] = field(default_factory=list)

    def _array(self) -> np.ndarray:
        return self.powers

    def __post_init__(self):
        self._clamp(1 << 17)

    def goto_freq(self, f_hz: float) -> None:
        self.lobin = int(max(0, min(f_hz * self.T - self.numbins // 2,
                                    len(self.powers) - self.numbins)))

    # -- data ----------------------------------------------------------
    def normalized(self) -> np.ndarray:
        """Median-normalized powers of the current window (the
        reference's chunked local normalization, explorefft.c's
        LOGLOCALCHUNK medians; powers/median * ln2 so chi^2 mean=1).
        norm_mode='raw' shows unnormalized powers
        (explorefft.c:944-951's 'r' submode)."""
        w = self.powers[self.lobin:self.lobin + self.numbins]
        if self.norm_mode == "raw":
            return np.asarray(w, dtype=np.float64)
        nc = max(1, len(w) // LOCALCHUNK)
        chunks, csize = _chunks_of(w, nc)
        med = np.median(chunks, axis=1)
        med = np.maximum(np.repeat(med, csize)[:len(w)], 1e-30)
        return (w / med) * np.log(2.0)

    def peak(self) -> Tuple[float, float]:
        """(r, normalized power) of the strongest displayed point."""
        f, p = self.display()
        i = int(np.argmax(p))
        return f[i] * self.T, float(p[i])

    def add_birdie(self) -> Tuple[float, float]:
        """Append the strongest displayed peak to the zaplist as
        (freq_hz, width_hz) — explorefft's 'Z' birdie capture with
        the interactive cursor span replaced by a LOCALCHUNK-bin
        width around the peak.  Returns the (freq, width) written."""
        r, _p = self.peak()
        f0 = r / self.T
        width = LOCALCHUNK / self.T
        with open(self.zapfile, "a") as fh:
            fh.write("%17.14g %17.14g\n" % (f0, width))
        self.zapped.append((f0, width))
        return f0, width

    def display(self) -> Tuple[np.ndarray, np.ndarray]:
        """(freqs_hz, display_powers) with <= DISPLAYNUM chunk-max
        points (explorefft shows the max so narrow peaks survive)."""
        norm = self.normalized()
        nout = min(DISPLAYNUM, len(norm))
        disp = _chunk_reduce(norm, nout, "max")
        rs = self.lobin + np.arange(len(disp)) * (len(norm) / len(disp))
        return rs / self.T, disp

    def harmonic_freqs(self) -> List[float]:
        if not self.harmonics or self.cursor_r <= 0:
            return []
        f0 = self.cursor_r / self.T
        return [f0 * k for k in range(1, self.harmonics + 1)]


@dataclass
class TimeseriesView(_WindowedView):
    """Windowed view of a .dat time series (exploredat.c model):
    chunked min/avg/max envelopes, median/average center toggle
    (exploredat.c:482-489) and envelope on/off (exploredat.c:475-481's
    space toggle)."""
    data: np.ndarray
    dt: float
    lobin: int = 0
    numbins: int = 0
    center: str = "avg"           # 'avg' | 'median' ('M' key toggle)
    show_envelope: bool = True    # ' ' toggles min/max band

    def _array(self) -> np.ndarray:
        return self.data

    def __post_init__(self):
        self._clamp(1 << 16)

    def display(self):
        """(times_s, center, mn, mx) chunk envelopes, <= DISPLAYNUM."""
        w = self.data[self.lobin:self.lobin + self.numbins]
        nout = min(DISPLAYNUM, len(w))
        if self.center == "median" and len(w) > nout:
            c, _ = _chunks_of(w, nout)
            avg = np.median(c, axis=1)
        else:
            avg = _chunk_reduce(w, nout, "avg")
        mn = _chunk_reduce(w, nout, "min")
        mx = _chunk_reduce(w, nout, "max")
        ts = (self.lobin + np.arange(len(avg)) *
              (len(w) / len(avg))) * self.dt
        return ts, avg, mn, mx

    def goto_time(self, t_sec: float) -> None:
        self.lobin = int(max(0, min(t_sec / self.dt - self.numbins // 2,
                                    len(self.data) - self.numbins)))

    def stats(self) -> Tuple[float, float, float, float]:
        w = self.data[self.lobin:self.lobin + self.numbins]
        return (float(w.mean()), float(w.std()),
                float(w.min()), float(w.max()))


HELP = """explore keys (explorefft.c / exploredat.c interaction model):
  a / i      zoom in (x2)
  x / o      zoom out (x2)
  < / left   shift left one full screen      , shift left 1/8 screen
  > / right  shift right one full screen     . shift right 1/8 screen
  + / -      taller / shorter powers, i.e. lower / raise the y
             ceiling (spectrum; explorefft.c's 'Increase height')
  s          auto-scale y
  g          center on the strongest displayed peak
  G          go to a typed frequency (Hz) / time (s)
  d          print details of the strongest displayed point
  h          toggle x16 harmonic markers at the strongest shown peak
  n          cycle normalization: local-median <-> raw   (spectrum)
  z          append strongest peak to the zaplist birdie file (spectrum)
  m          toggle chunk center median <-> average   (time series)
  space      toggle the min/max envelope band         (time series)
  v          print window statistics
  p          save the current plot to a PNG
  ?          print this help
  q          quit
"""


def dispatch_key(view, key, arg: Optional[float] = None):
    """Headless keystroke dispatch: mutate `view` per the reference's
    interaction model (explorefft.c:637-1007, exploredat.c:460-730)
    and return the ACTION for the caller to perform:

      ("redraw", None)  view changed, re-render
      ("quit", None)    close
      ("print", text)   write text to the terminal
      ("save", None)    save the current figure (caller names it)
      ("prompt", what)  ask the user for a number, then call again
                        with arg=<value> and the same key
      None              key not bound

    `arg` carries the answer to a ("prompt", ...) round trip ('G').
    Pure logic + zapfile append — no matplotlib: tests drive it
    headless, the apps wire it to key_press_event."""
    spec = isinstance(view, SpectrumView)
    if key == "q":
        return ("quit", None)
    if key == "?":
        return ("print", HELP)
    if key in ("a", "i"):
        view.zoom(0.5)
        return ("redraw", None)
    if key in ("x", "o"):
        view.zoom(2.0)
        return ("redraw", None)
    if key in ("<", "left"):
        view.pan(-1.0)
        return ("redraw", None)
    if key == ",":
        view.pan(-0.125)
        return ("redraw", None)
    if key in (">", "right"):
        view.pan(1.0)
        return ("redraw", None)
    if key == ".":
        view.pan(0.125)
        return ("redraw", None)
    if key in ("+", "=") and spec:
        _, p = view.display()
        cur = view.yscale or float(np.max(p))
        view.yscale = cur / 1.25
        return ("redraw", None)
    if key in ("-", "_") and spec:
        _, p = view.display()
        cur = view.yscale or float(np.max(p))
        view.yscale = cur * 1.25
        return ("redraw", None)
    if key == "s":
        if spec:
            view.yscale = 0.0
        return ("redraw", None)
    if key == "g":
        if spec:
            r, _p = view.peak()
            view.goto_freq(r / view.T)
        else:
            ts, avg, _mn, mx = view.display()
            view.goto_time(float(ts[int(np.argmax(mx))]))
        return ("redraw", None)
    if key == "G":
        if arg is None:
            return ("prompt", "frequency (Hz)" if spec else "time (s)")
        if spec:
            view.goto_freq(float(arg))
        else:
            view.goto_time(float(arg))
        return ("redraw", None)
    if key == "d":
        if spec:
            r, p = view.peak()
            period = "P=%.6g s" % (view.T / r) if r > 0 else "P=inf"
            return ("print",
                    "peak: r=%.1f  f=%.9g Hz  %s  norm power "
                    "%.3f" % (r, r / view.T, period, p))
        mean, std, lo, hi = view.stats()
        return ("print", "window mean %.6g  std %.6g  min %.6g  "
                "max %.6g" % (mean, std, lo, hi))
    if key == "h" and spec:
        if view.harmonics:
            view.harmonics = 0
        else:
            view.cursor_r, _ = view.peak()
            view.harmonics = 16
        return ("redraw", None)
    if key == "n" and spec:
        view.norm_mode = "raw" if view.norm_mode == "median" \
            else "median"
        return ("redraw", None)
    if key == "z" and spec:
        f0, width = view.add_birdie()
        return ("print", "added birdie %.9g Hz (width %.3g Hz) -> %s"
                % (f0, width, view.zapfile))
    if key == "m" and not spec:
        view.center = "median" if view.center == "avg" else "avg"
        return ("redraw", None)
    if key == " " and not spec:
        view.show_envelope = not view.show_envelope
        return ("redraw", None)
    if key == "v":
        if spec:
            f, p = view.display()
            return ("print", "window %.6f-%.6f Hz, max norm power "
                    "%.2f" % (f[0], f[-1], float(p.max())))
        return ("print", "mean/std/min/max: %r" % (view.stats(),))
    if key == "p":
        return ("save", None)
    return None


def render_spectrum(view: SpectrumView, ax) -> None:
    f, p = view.display()
    ax.clear()
    ax.plot(f, p, lw=0.6, color="#2060a0")
    for i, hf in enumerate(view.harmonic_freqs()):
        if f[0] <= hf <= f[-1]:
            ax.axvline(hf, color="#c04040", lw=0.7, alpha=0.6)
    ax.set_xlabel("Frequency (Hz)")
    ax.set_ylabel("Normalized power" if view.norm_mode == "median"
                  else "Raw power")
    ax.set_title("bins %d - %d of %d  (max-of-chunk display)"
                 % (view.lobin, view.lobin + view.numbins,
                    len(view.powers)))
    ax.set_xlim(f[0], f[-1])
    if view.yscale:
        ax.set_ylim(0.0, view.yscale)


def render_timeseries(view: TimeseriesView, ax) -> None:
    ts, avg, mn, mx = view.display()
    ax.clear()
    if view.show_envelope and view.numbins > len(avg):
        ax.fill_between(ts, mn, mx, color="#a0c0e0", alpha=0.7,
                        label="min/max")
    ax.plot(ts, avg, lw=0.6, color="#2060a0", label=view.center)
    mean, std, lo, hi = view.stats()
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Amplitude")
    ax.set_title("bins %d - %d of %d   mean %.3g  std %.3g"
                 % (view.lobin, view.lobin + view.numbins,
                    len(view.data), mean, std))
    ax.set_xlim(ts[0], ts[-1])


def run_explorer(view, render, out_png: Optional[str] = None) -> str:
    """Interactive loop when a GUI backend is up; else render a PNG.
    Returns the mode used ('interactive' or the png path)."""
    from presto_tpu_torch.plotting import pyplot
    plt = pyplot("the explorer")
    import matplotlib

    interactive = (out_png is None and
                   matplotlib.get_backend().lower() not in
                   ("agg", "pdf", "svg", "ps", "cairo", "template"))
    fig, ax = plt.subplots(figsize=(11, 5))
    render(view, ax)
    if not interactive:
        path = out_png or "explore.png"
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path

    print(HELP)
    nsaved = [0]

    def perform(action):
        if action is None:
            return
        verb, payload = action
        if verb == "quit":
            plt.close(fig)
        elif verb == "print":
            print(payload)
        elif verb == "save":
            path = "explore_%02d.png" % nsaved[0]
            nsaved[0] += 1
            fig.savefig(path, dpi=110)
            print("saved", path)
        elif verb == "prompt":
            try:
                val = float(input("%s> " % payload))
            except (ValueError, EOFError):
                return
            perform(dispatch_key(view, "G", arg=val))
            return
        if verb in ("redraw",):
            render(view, ax)
            fig.canvas.draw_idle()

    def on_key(event):
        perform(dispatch_key(view, event.key))

    fig.canvas.mpl_connect("key_press_event", on_key)
    plt.show()
    return "interactive"
