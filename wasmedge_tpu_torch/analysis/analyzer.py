"""Per-block divergence scores of a lowered module.

The part of `wasmedge_tpu/analysis/analyzer.py` (`analyze_module`,
`:397-402` and `:527-536`) that lane compaction reads
(batch/compact.py `divergence_key`): for every defined function its CFG
(analysis/cfg.py) and, per basic block, a divergence-risk score: the
branch fan-out (successors - 1) plus the br_table entries, plus 4 when
the block makes a dynamic call, doubled when the block is on a CFG
cycle.  The JAX analyzer's cost bounds, abstract interpretation, n-gram
census, host-call inventory and report are not copied: nothing on the
port's path reads them.
"""

from __future__ import annotations

import dataclasses
from typing import List

from wasmedge_tpu_torch.analysis.cfg import BasicBlock, FuncCFG, \
    build_func_cfg
from wasmedge_tpu_torch.validator.image import LoweredModule


@dataclasses.dataclass
class FuncAnalysis:
    idx: int
    cfg: FuncCFG
    block_divergence: List[int]  # per block, in cfg.blocks order


@dataclasses.dataclass
class ModuleAnalysis:
    funcs: List[FuncAnalysis]  # the defined functions, in index order


def block_divergence(b: BasicBlock) -> int:
    """The block's divergence-risk score (analyzer.py:527-536)."""
    score = max(len(b.succ) - 1, 0) + b.brtable_entries \
        + (4 if b.dynamic_call else 0)
    return score * 2 if b.in_loop else score


def analyze_module(image: LoweredModule) -> ModuleAnalysis:
    """CFG and per-block divergence scores of every defined function."""
    funcs = []
    for i, fn in enumerate(image.funcs):
        if fn.is_import:
            continue
        cfg = build_func_cfg(image, i)
        funcs.append(FuncAnalysis(
            idx=i, cfg=cfg,
            block_divergence=[block_divergence(b) for b in cfg.blocks]))
    return ModuleAnalysis(funcs=funcs)
