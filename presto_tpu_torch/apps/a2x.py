"""a2x: render ASCII text files to printable PDF/PNG pages.

The reference vendors the 1994 a2x ASCII->PostScript pretty-printer
(bin/a2x + lib/a2x.ps, third-party GPL) so its text reports can be
printed; this rebuild renders the same monospaced pages natively with
matplotlib (PostScript-era output replaced per SURVEY §7.4, like the
other PGPLOT surfaces).  Core knobs kept: portrait/landscape, lines
per page, optional two-column layout, per-page header with filename
and page number.

Usage: python -m presto_tpu_torch.apps.a2x report.txt [-o report.pdf]

Host copy of ``presto_tpu/apps/a2x.py`` for the PyTorch port, which
imports nothing from the JAX package. The pages need matplotlib, which
the card machine does not have: there a run raises ImportError naming it
before it reads a file.
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(prog="a2x")
    p.add_argument("textfiles", nargs="+")
    p.add_argument("-o", default=None,
                   help="Output file for a SINGLE input (default "
                        "<input>.pdf; a .png output renders the "
                        "FIRST page only)")
    p.add_argument("-landscape", action="store_true")
    p.add_argument("-columns", type=int, default=1, choices=(1, 2))
    p.add_argument("-lines", type=int, default=66,
                   help="Text lines per page column (default 66)")
    p.add_argument("-noheader", action="store_true")
    return p


def _paginate(lines, per_page):
    for i in range(0, max(len(lines), 1), per_page):
        yield lines[i:i + per_page]


def render_text(path: str, out: str, landscape: bool = False,
                columns: int = 1, lines_per: int = 66,
                header: bool = True) -> str:
    """Render one text file to `out` (.pdf = multi-page, .png = first
    page).  Returns the output path."""
    from presto_tpu_torch.plotting import pyplot
    plt = pyplot("a2x")
    from matplotlib.backends.backend_pdf import PdfPages

    with open(path, errors="replace") as fh:
        lines = [ln.rstrip("\n").expandtabs() for ln in fh]
    size = (11.0, 8.5) if landscape else (8.5, 11.0)
    per_page = lines_per * columns
    pages = list(_paginate(lines, per_page))
    is_pdf = out.lower().endswith(".pdf")
    sink = PdfPages(out) if is_pdf else None
    try:
        for pno, page in enumerate(pages, 1):
            fig = plt.figure(figsize=size)
            if header:
                fig.text(0.06, 0.97, os.path.basename(path),
                         family="monospace", fontsize=9)
                fig.text(0.94, 0.97, "page %d/%d"
                         % (pno, len(pages)),
                         family="monospace", fontsize=9, ha="right")
            for col in range(columns):
                chunk = page[col * lines_per:(col + 1) * lines_per]
                x = 0.06 + col * (0.88 / columns)
                fig.text(x, 0.94, "\n".join(chunk),
                         family="monospace", fontsize=7,
                         va="top", linespacing=1.3)
            if is_pdf:
                sink.savefig(fig)
            else:
                fig.savefig(out, dpi=150)
                plt.close(fig)
                if len(pages) > 1:     # raster sink holds ONE page
                    print("a2x: %s holds page 1 of %d — use a .pdf "
                          "output for the full document"
                          % (out, len(pages)))
                break
            plt.close(fig)
    finally:
        if sink is not None:
            sink.close()
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.o and len(args.textfiles) > 1:
        raise SystemExit("a2x: -o needs a single input file")
    for f in args.textfiles:
        out = args.o or (os.path.splitext(f)[0] + ".pdf")
        print("a2x: wrote %s" % render_text(
            f, out, landscape=args.landscape, columns=args.columns,
            lines_per=args.lines, header=not args.noheader))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
