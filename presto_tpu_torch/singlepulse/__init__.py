"""Single-pulse diagnostic toolchain (host code).

Host copy of ``presto_tpu/singlepulse`` for the PyTorch port.

The reference ships this as lib/python/singlepulse/ (spcand.py, spio.py,
make_spd.py, plot_spd.py, rrattrap.py, bary_and_topo.py) plus
bin/waterfaller.py — grouping/rating of .singlepulse events across DM
trials (the "RRAT trap"), candidate cutout waterfalls, and the .spd
diagnostic bundle.  The search itself lives in
presto_tpu_torch.search.singlepulse; this package is the downstream analysis.
"""

from presto_tpu_torch.singlepulse.grouping import (SinglePulseGroup,
                                                   group_candidates,
                                                   rank_groups)
from presto_tpu_torch.singlepulse.spd import SpdData, make_spd, read_spd
from presto_tpu_torch.singlepulse.waterfaller import waterfall

__all__ = ["SinglePulseGroup", "group_candidates", "rank_groups",
           "waterfall", "SpdData", "make_spd", "read_spd"]
