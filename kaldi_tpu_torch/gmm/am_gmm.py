"""AmDiagGmm: one DiagGmm per pdf, packed for one GEMM over ALL pdfs.

Counterpart of kaldi_tpu/gmm/am_gmm.py (ref: gmm/am-diag-gmm.h:36
AmDiagGmm; gmm/decodable-am-diag-gmm.h:45). Every gaussian of every pdf
sits in one [2D+1, G] matrix; scoring [..., T, D] frames against all pdfs
is

    aug[..., T, 2D+1] @ packed[2D+1, G] -> component loglikes [..., T, G]
    segment log-sum-exp over G by pdf   -> [..., T, num_pdfs]

Pdfs have uneven component counts. JAX's `segment_max` / `segment_sum`
become gathers of each pdf's components into a padded [..., num_pdfs,
Gmax] block (the table of `nnet/combine.py`'s group sum), reduced over
its last dim: the order of the sum is fixed (an `index_add` would use
atomics on CUDA). The product runs in true f32 (JAX
asks Precision.HIGHEST; `resolve_device` turns TF32 off on the card).

The parameters stay numpy DiagGmms on the host; the packed matrix and the
segment tables are copied to the model's device once per change
(`invalidate` drops them).
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.nnet.combine import _group_table


class AmDiagGmm:
    """Per-pdf DiagGmms scored on `device` (the card unless the caller asks
    for "cpu")."""

    def __init__(self, pdfs: list[DiagGmm], device="cuda"):
        self.pdfs = list(pdfs)
        self.device = resolve_device(device)
        self._packed_cache = None
        self._dev_cache = None

    @property
    def num_pdfs(self) -> int:
        return len(self.pdfs)

    @property
    def dim(self) -> int:
        return self.pdfs[0].dim

    @property
    def total_gauss(self) -> int:
        return sum(p.num_gauss for p in self.pdfs)

    def invalidate(self):
        self._packed_cache = None
        self._dev_cache = None

    def pack(self):
        """-> (packed [2D+1, G] f32, seg_ids [G] i32), host numpy."""
        if self._packed_cache is None:
            packed = np.concatenate([p.packed() for p in self.pdfs], axis=1)
            seg = np.concatenate(
                [np.full(p.num_gauss, i, np.int32)
                 for i, p in enumerate(self.pdfs)])
            self._packed_cache = (packed, seg)
        return self._packed_cache

    def device_pack(self):
        """-> (packed [2D+1, G] f32, seg_ids [G] int64, table [num_pdfs,
        Gmax] int64) on the model's device."""
        if self._dev_cache is None:
            packed, seg = self.pack()
            dev = self.device
            self._dev_cache = (
                torch.as_tensor(packed, device=dev),
                torch.as_tensor(seg.astype(np.int64), device=dev),
                torch.as_tensor(_group_table(seg, self.num_pdfs),
                                device=dev))
        return self._dev_cache

    def loglikes(self, feats, scale: float = 1.0) -> torch.Tensor:
        """feats [..., T, D] (numpy or tensor) -> per-pdf loglikes
        [..., T, num_pdfs] f32 on the model's device."""
        packed, seg, table = self.device_pack()
        x = torch.as_tensor(feats).to(device=self.device, dtype=torch.float32)
        return _am_loglikes(x, packed, seg, table, float(scale))

    def loglikes_np(self, feats, scale: float = 1.0) -> np.ndarray:
        return self.loglikes(feats, scale).cpu().numpy()

    # --- model surgery ---

    def split_by_count(self, target_total: int, perturb_factor=0.01,
                       power: float = 0.2, min_count: float = 20.0,
                       occs: np.ndarray | None = None,
                       rng=None):
        """Distribute `target_total` gaussians across pdfs ∝ occupancy^power
        (ref: am-diag-gmm.cc SplitByCount / GetSplitTargets)."""
        rng = rng or np.random.RandomState(0)
        if occs is None:
            occs = np.ones(self.num_pdfs)
        occs = np.asarray(occs, np.float64)
        powered = np.power(np.maximum(occs, 1e-10), power)
        shares = powered / powered.sum() * target_total
        targets = np.maximum(1, np.floor(shares).astype(int))
        # distribute the flooring remainder to the largest fractional
        # parts so the requested TOTAL is actually reached
        # (ref: GetSplitTargets allocates iteratively to hit the total)
        short = int(target_total - targets.sum())
        if short > 0:
            frac = shares - np.floor(shares)
            frac[occs < min_count] = -1.0   # ineligible pdfs
            for i in np.argsort(-frac)[:short]:
                if frac[i] > 0:
                    targets[i] += 1
        # pdfs with occupancy below min_count stay at current size
        for i, p in enumerate(self.pdfs):
            t = int(targets[i])
            if occs[i] < min_count:
                continue
            if t > p.num_gauss:
                self.pdfs[i] = p.split(t, perturb_factor, rng)
        self.invalidate()

    def copy(self) -> "AmDiagGmm":
        return AmDiagGmm([p.copy() for p in self.pdfs], self.device)


def _augment(x: torch.Tensor) -> torch.Tensor:
    """[..., D] -> [..., 2D+1] = [x, -0.5 x^2, 1]."""
    ones = torch.ones(x.shape[:-1] + (1,), dtype=torch.float32,
                      device=x.device)
    return torch.cat([x, -0.5 * x * x, ones], dim=-1)


def _am_loglikes(x: torch.Tensor, packed: torch.Tensor, seg: torch.Tensor,
                 table: torch.Tensor, scale: float) -> torch.Tensor:
    """kaldi_tpu `_am_loglikes`: x [..., T, D] f32 -> [..., T, num_pdfs].

    An empty segment's max is -inf, taken as 0 (JAX's `where(isfinite)`),
    and its sum 0, floored at 1e-37 under the log."""
    comp_ll = torch.matmul(_augment(x), packed)              # [..., T, G]
    pad = comp_ll.new_full(comp_ll.shape[:-1] + (1,), float("-inf"))
    seg_max = torch.amax(torch.cat([comp_ll, pad], dim=-1)[..., table],
                         dim=-1)                             # [..., T, C]
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    e = torch.exp(comp_ll - seg_max.index_select(-1, seg))
    seg_sum = torch.sum(torch.cat([e, torch.zeros_like(pad)], dim=-1)
                        [..., table], dim=-1)
    ll = seg_max + torch.log(torch.clamp(seg_sum, min=1e-37))
    return scale * ll
