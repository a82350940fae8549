"""The serving engine's concatenated image (batch/multitenant.py
`MultiModuleBatchEngine`) against the JAX package's: `module:func` and
bare names, result arities, owners and exports, and the lane-uniform
initial state of every exported function plane by plane, with and
without a hand-made snapshot overlay (memory, pages, globals, table,
table size and dropped segment flags)."""

import numpy as np
import pytest

from wasmedge_tpu.batch.multitenant import (
    MultiModuleBatchEngine as RefMultiModule)
from wasmedge_tpu.common.configure import Proposal as RefProposal
from wasmedge_tpu_torch.batch.multitenant import MultiModuleBatchEngine
from wasmedge_tpu_torch.common.configure import Proposal
from wasmedge_tpu_torch.models.fixtures import (
    TABLE_ZOO_CAP, build_clash_a, build_clash_b, build_table_zoo)
from tests.test_torch_interp import _assert_planes, _ref_planes
from tests.test_torch_multitenant import _conf, inst_of

LANES = 6
MODULES = (("a", build_clash_a), ("b", build_clash_b),
           ("zoo", build_table_zoo))
NAMES = ("a:go", "b:go", "go", "zoo:grow", "zoo:init", "zoo:meminit",
         "zoo:refs")


def _overlays():
    """Snapshot overlays as a capture would give them: module a's memory
    (a word at byte 8), pages and global; the zoo's table (funcidx + 1,
    rebased by the engine), size and dropped flags."""
    mem = np.zeros(1024, np.int32)
    mem[2] = 77
    return {"a": {"mem": mem, "mem_pages": 1,
                  "glob_lo": np.array([1234], np.int32),
                  "glob_hi": np.array([0], np.int32)},
            "zoo": {"tab": np.array([2, 0, 3, 1, 0, 2], np.int32),
                    "tsize": 6, "edrop": np.array([1, 0], np.int32),
                    "ddrop": np.array([0, 1], np.int32)}}


def _engines(overlays=None):
    out = []
    for pkg in ("port", "ref"):
        conf = _conf(pkg)
        conf.add_proposal((Proposal if pkg == "port"
                           else RefProposal).TailCall)
        conf.batch.table_elems_per_lane = TABLE_ZOO_CAP
        mods = [(name, *inst_of(pkg, build(), conf))
                for name, build in MODULES]
        kw = {} if overlays is None else dict(init_overlays=overlays,
                                              snapshot_counts={})
        if pkg == "port":
            out.append(MultiModuleBatchEngine(mods, conf=conf, lanes=LANES,
                                              device="cpu", **kw))
        else:
            out.append(RefMultiModule(mods, conf=conf, lanes=LANES, **kw))
    return out


def test_names_arities_owners_and_exports():
    port, ref = _engines()
    for name in NAMES:
        k = port.export_func_idx(name)
        assert k == ref.export_func_idx(name), name
        assert port.func_nresults(k) == ref.func_nresults(k), name
        assert port.func_owner(k) == ref.func_owner(k), name
    assert port.export_func_idx("go") == port.export_func_idx("a:go")
    for mod, _ in MODULES:
        assert port.exported_funcs(mod) == ref.exported_funcs(mod)
    for bad in ("c:go", "b:nope", "nope"):
        with pytest.raises(KeyError):
            port.export_func_idx(bad)
    assert port.inst is None and port.t0kinds is None


@pytest.mark.parametrize("overlay", [False, True])
def test_initial_state_equals_jax(overlay):
    port, ref = _engines(_overlays() if overlay else None)
    rng = np.random.default_rng(7)
    for name in NAMES:
        k = port.export_func_idx(name)
        nargs = int(port.img.f_nparams[k])
        args = [rng.integers(-9, 99, LANES) for _ in range(nargs)]
        got = port.initial_state(k, args).to_numpy()
        want = _ref_planes(ref.initial_state(k, args))
        _assert_planes(got, want, f"{name}, overlay={overlay}")
        # lane-uniform but for the argument rows
        for f, p in got.items():
            if p is not None and f not in ("stack_lo", "stack_hi"):
                assert (p == p[..., :1]).all(), (name, f)
    if overlay:
        zoo = port.export_func_idx("zoo:grow")
        st = port.initial_state(zoo, [np.zeros(LANES), np.zeros(LANES)])
        base = port.bases[2]["table"]
        assert st.tab[base:base + 6, 0].tolist() == \
            [2 + port.bases[2]["func"], 0, 3 + port.bases[2]["func"],
             1 + port.bases[2]["func"], 0, 2 + port.bases[2]["func"]]
        assert (st.tsize == 6).all()
        a = port.initial_state(port.export_func_idx("a:go"), [np.ones(LANES)])
        assert (a.mem[2] == 77).all()
        assert (a.glob_lo[port.bases[0]["glob"]] == 1234).all()


def test_snapshot_installs_are_counted():
    port, ref = _engines(_overlays())
    for eng in (port, ref):
        eng.note_snapshot_install(eng.export_func_idx("a:go"), 3)
        eng.note_snapshot_install(eng.export_func_idx("b:go"), 5)
        eng.note_snapshot_install(eng.export_func_idx("zoo:refs"), 2)
    assert port.snapshot_counts == ref.snapshot_counts == {"installs": 5}
