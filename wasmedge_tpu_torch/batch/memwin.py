"""Plain PyTorch version of the memory window cache (B4, `csrc/memwin.cuh`).

Counterpart of the window cache of `wasmedge_tpu/batch/pallas_engine.py`
(`_win_select` :1779, `_win_flush` :1834, `win_read_row` /
`win_write_row` :1849-1862, the launch init :3656-3660 and the exit
commit :3683-3693).  The Pallas kernel keeps the memory plane in HBM and
two windows of `HBM_WINDOW_ROWS` rows per lane block in VMEM, chosen for
the whole block at once.  The CUDA kernel chooses them per lane (an H100
thread has its own addresses), so this module keeps, for every lane,

  - `wb [2, L]`: the first plane row of each way (`SENT` when invalid),
  - `wd [2, L]`: whether the way holds writes not yet in the plane,
  - `mru [L]`: the way used last (the other is the victim of a miss),
  - `rows [2, CW, L]`: the windows' words,

with the JAX rules: a window is based at `align8(rlo)` clipped to
`[0, W - CW]`; a miss replaces the least recently used way, writing it
back first when dirty; and at most one way holds any plane row, so an
incoming window that overlaps the other way writes that way back (when
dirty) and invalidates it before the fill reads the plane.  Windows start
invalid at every launch, and `flush` writes every dirty way back at its
end, so the plane after a launch is what direct access would leave.

Optimistic convergence (B3, `batch/optimistic.py`) keeps the plane
validated: `dirty_miss` tells whether a select would write a dirty way
back (a commit point in "on" warps), `commit` writes the dirty ways back
and keeps them valid, and `invalidate` drops the windows on a rollback.

The instructions that work on the plane itself (memory.fill /
memory.copy, memory.init from a data segment, and the tier-0 calls that
touch memory) first `flush` the lane's windows: its dirty ways go back to
the plane and none stays valid, so the next access fills again.

`COUNTS` sums, over every `MemWindows` since it was last set to 0, the
misses (selects that hit neither way) and the ways written back (a dirty
way: one with a write not yet in the plane), by the kernel's rule: the
CUDA kernel's `interp.window_counts` gives the same two numbers for the
same launches.  The kernel moves rows, not ways (per-row valid and dirty
bits, `csrc/memwin.cuh`); what it leaves in the plane is what this version
leaves.
"""

from __future__ import annotations

import torch

HBM_WINDOW_ROWS = 128  # CW: words per way (pallas_engine.py :3893)
SENT = -(1 << 30)      # the base of an invalid way
COUNTS = {"misses": 0, "ways_written_back": 0}


def clear_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


class MemWindows:
    """Two windows of CW words of each lane's column of `mem` [W, L]."""

    def __init__(self, mem: torch.Tensor, cw: int = HBM_WINDOW_ROWS):
        W, L = mem.shape
        if W < cw:
            raise ValueError(f"a memory of {W} words cannot hold a "
                             f"{cw}-word window")
        self.mem, self.cw, self.W = mem, cw, W
        dev = mem.device
        self.wb = torch.full((2, L), SENT, dtype=torch.int32, device=dev)
        self.wd = torch.zeros((2, L), dtype=torch.bool, device=dev)
        self.mru = torch.zeros(L, dtype=torch.int32, device=dev)
        self.rows = torch.zeros((2, cw, L), dtype=torch.int32, device=dev)

    def _span(self, base):
        """Plane rows [base, base + CW) per lane: [CW, n] indices."""
        return base.long()[None, :] + torch.arange(
            self.cw, device=base.device)[:, None]

    def _writeback(self, way: int, lanes):
        """Write way `way` of `lanes` back to the plane (dirty ones)."""
        lanes = lanes[self.wd[way, lanes]]
        COUNTS["ways_written_back"] += lanes.numel()
        if lanes.numel():
            self.mem[self._span(self.wb[way, lanes]), lanes[None, :]] = \
                self.rows[way][:, lanes]
            self.wd[way, lanes] = False

    def select(self, lanes, rlo, rhi, en=None):
        """Make plane rows [rlo, rhi] (rhi - align8(rlo) < CW, both in the
        plane) resident in one way on the lanes of `en` (all when None).
        Returns the way per lane, for `read` and `write`."""
        cw, W = self.cw, self.W
        if en is None:
            en = torch.ones_like(rlo, dtype=torch.bool)
        wb, mru = self.wb[:, lanes], self.mru[lanes]
        hit0 = (rlo >= wb[0]) & (rhi < wb[0] + cw)
        hit1 = (rlo >= wb[1]) & (rhi < wb[1] + cw)
        nb = (rlo - rlo % 8).clamp(0, W - cw).to(torch.int32)
        miss = en & ~(hit0 | hit1)
        COUNTS["misses"] += int(miss.sum())
        vic = (mru == 0).to(torch.int32)  # 1: way 1 is the victim
        for way in (0, 1):
            repl = miss & (vic == way)
            other = 1 - way
            ov = repl & (wb[other] < nb + cw) & (nb < wb[other] + cw)
            # the single-resident-copy rule, then the victim, then the fill
            if bool(ov.any()):
                ol = lanes[ov]
                self._writeback(other, ol)
                self.wb[other, ol] = SENT
            if bool(repl.any()):
                rl = lanes[repl]
                self._writeback(way, rl)
                self.rows[way][:, rl] = self.mem[self._span(nb[repl]),
                                                 rl[None, :]]
                self.wb[way, rl] = nb[repl]
        way = torch.where(hit0, 0, torch.where(hit1, 1, vic)).to(torch.int32)
        self.mru[lanes] = torch.where(en, way, mru)
        return way

    def _index(self, lanes, way, r):
        w = way.long()
        i = (r - self.wb[w, lanes]).clamp(0, self.cw - 1).long()
        return w, i

    def read(self, lanes, way, r):
        """Word of plane row r (resident in `way`) of each lane."""
        w, i = self._index(lanes, way, r)
        return self.rows[w, i, lanes]

    def write(self, lanes, way, r, vals, mask):
        """Word of plane row r (resident in `way`) gets vals where mask."""
        w, i = self._index(lanes, way, r)
        w, i, lanes = w[mask], i[mask], lanes[mask]
        self.rows[w, i, lanes] = vals[mask]
        self.wd[w, lanes] = True

    def flush(self, lanes=None):
        """Write every dirty way of `lanes` (all when None) back and
        invalidate both (`_win_flush`)."""
        if lanes is None:
            lanes = torch.arange(self.mru.shape[0], device=self.mru.device)
        for way in (0, 1):
            self._writeback(way, lanes)
        self.wb[:, lanes] = SENT
        self.mru[lanes] = 0

    def dirty_miss(self, lanes, rlo, rhi):
        """Per lane: whether `select(rlo, rhi)` would write a dirty way
        back (the victim, or the other way under the overlap rule;
        pallas_engine.py :1905-1922)."""
        cw, W = self.cw, self.W
        wb, wd, mru = self.wb[:, lanes], self.wd[:, lanes], self.mru[lanes]
        hit = ((rlo >= wb[0]) & (rhi < wb[0] + cw)) | \
            ((rlo >= wb[1]) & (rhi < wb[1] + cw))
        nb = (rlo - rlo % 8).clamp(0, W - cw)
        ov0 = (wb[0] < nb + cw) & (nb < wb[0] + cw)
        ov1 = (wb[1] < nb + cw) & (nb < wb[1] + cw)
        need = torch.where(mru == 0, wd[1] | (wd[0] & ov0),
                           wd[0] | (wd[1] & ov1))
        return ~hit & need

    def commit(self, lanes):
        """Write the dirty ways of `lanes` back; they stay valid, clean."""
        for way in (0, 1):
            self._writeback(way, lanes)

    def invalidate(self, lanes):
        """Drop both ways of `lanes` without writing them back."""
        self.wb[:, lanes] = SENT
        self.wd[:, lanes] = False
        self.mru[lanes] = 0
