"""The stage reducer's input checks, once per tensor.

``accel_cuda.reduce_stages`` launches the kernel only on inputs it can
take: z maps inside the plane that never decrease, and slabs inside the
plane's columns.  It checks each input tensor once (one device-to-host
copy), and again only after the tensor changes or is used against
another plane or slab, so a launch makes no device-to-host copy.  The
checks run here on CPU tensors; the launch itself needs the card.
"""

import numpy as np
import pytest
import torch

from presto_tpu_torch.search import accel, accel_cuda


def zmaps(zmax=20, numharm=8, nrows=24):
    cfg = accel.AccelConfig(zmax=zmax, numharm=numharm)
    return torch.from_numpy(np.stack([
        np.concatenate([z, np.arange(cfg.numz, nrows)])
        for st in accel._harm_fracs_and_zinds(cfg, cfg.numz)
        for (_h, _t, z) in st]).astype(np.int32))


@pytest.fixture
def host_copies(monkeypatch):
    """Counts the checks' copies to the host."""
    calls = []
    cpu = torch.Tensor.cpu

    def counting(t, *a, **k):
        calls.append(t.shape)
        return cpu(t, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    return calls


def test_searcher_maps_pass_once(host_copies):
    zi = zmaps()
    for _ in range(3):
        accel_cuda.check_zmaps(zi, 24)
    assert len(host_copies) == 1
    accel_cuda.check_zmaps(zi, 25)          # another plane: checked again
    assert len(host_copies) == 2


@pytest.mark.parametrize("bad", ["decreasing", "negative", "past_plane"])
def test_bad_maps_raise(bad):
    zi = zmaps()
    if bad == "decreasing":
        zi[2, 10] = zi[2, 9] - 1
    elif bad == "negative":
        zi[0, 0] = -1
    else:
        zi[6, -1] = 24
    with pytest.raises(ValueError):
        accel_cuda.check_zmaps(zi, 24)


def test_changed_map_is_checked_again():
    zi = zmaps()
    accel_cuda.check_zmaps(zi, 24)
    zi[3, 5:] = 0                            # in place: a new version
    with pytest.raises(ValueError, match="decreases"):
        accel_cuda.check_zmaps(zi, 24)


def test_start_cols(host_copies):
    sc = torch.tensor([0, 1234, 3999], dtype=torch.int32)
    accel_cuda.check_start_cols(sc, 1000, 5000)
    accel_cuda.check_start_cols(sc, 1000, 5000)
    assert len(host_copies) == 1
    with pytest.raises(ValueError, match="runs off"):
        accel_cuda.check_start_cols(sc, 1002, 5000)
    with pytest.raises(ValueError, match="runs off"):
        accel_cuda.check_start_cols(torch.tensor([-1], dtype=torch.int32),
                                    10, 5000)
