"""Multi-tenant batching: many modules, one lane batch.

A trimmed copy of `wasmedge_tpu/batch/multitenant.py` (BASELINE config
5, the serverless mix): every tenant's DeviceImage is appended into one
image with its code, function, global, type, table, br_table, v128 and
segment index spaces rebased, and each lane starts at its own tenant's
entry pc with its own memory, pages and table size.  The CUDA
interpreter keeps one pc per lane, so the concatenated image runs
through the same `run_from_state` as any image: per-lane heterogeneous
execution needs no kernel of its own.  `call_indirect` and the table
ops read their table's window from the instruction, so each tenant's
calls stay inside its own table slot, and `memory.grow` reads its page
ceiling from the instruction (`b`), so each tenant keeps its own
module's ceiling, as a solo run and the Wasm spec do (ROADMAP C10: the
reference's SIMT path gives every tenant the largest one).

Left out, with the reasons:
- the reference's Pallas route (`_try_pallas`, `_try_schedulers` with
  `BlockScheduler`) exists because a TPU block runs one pc; a CUDA lane
  has its own, so the concatenated image needs no per-tenant engines;
- the memfuse and tier-up planes (`fuse_len`, `fuse_pat`,
  `fuse_patterns`, `tier_fn`): the port has neither planner; its B2 and
  B6 planners (`batch/fusion.py`) run over the concatenated image as
  over any image;
- the mesh argument and the recorder wait for their subsystems.

The gateway (gateway/registry.py) hands `MultiModuleBatchEngine` the
one-lane engines it built at registration (`engines=`), so that a
generation swap lowers nothing again, and an image store's
`SegmentCache` (`segment_cache=`, imagestore/segments.py), so that
`concat_images` rebases only the segments it has not built before.

Lane compaction (`conf.batch.compact`, batch/compact.py): `run_tenants`
arms a compactor as `BatchEngine.run` does; its permutations cross the
tenants' slices, and `results_from_state` gathers the planes back to the
lanes' order before it cuts them per tenant.  The concatenated image has
no analysis, so the sort keys on (function, pc).

A concatenated image carries no tier-0 plane, so `t0_effective_kinds` is
None and every tenant's host calls are served between launches through
its own instance (`resolve_func`): its own WASI environ.  The engine has
no single instance (`inst` is None), so nothing can reach one tenant's
environ through it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from wasmedge_tpu_torch.batch.compact import arm, restore_mirrors
from wasmedge_tpu_torch.batch.engine import (
    BatchEngine, BatchResult, BatchState, a3_plane_rows,
    check_batch_entry, decode_results, memory_words, pack_lane_args,
    resolve_device)
from wasmedge_tpu_torch.batch.image import (
    CLS_BR, CLS_BR_TABLE, CLS_BRNZ, CLS_BRZ, CLS_CALL, CLS_CALL_INDIRECT,
    CLS_DATA_DROP, CLS_ELEM_DROP, CLS_GLOBAL_GET, CLS_GLOBAL_SET,
    CLS_HOSTCALL, CLS_MEMINIT, CLS_REFFUNC, CLS_RETCALL,
    CLS_RETCALL_INDIRECT, CLS_TABLE_COPY, CLS_TABLE_FILL, CLS_TABLE_GET,
    CLS_TABLE_GROW, CLS_TABLE_INIT, CLS_TABLE_SET, CLS_TABLE_SIZE,
    CLS_VCONST, CLS_VSHUFFLE, DeviceImage)
from wasmedge_tpu_torch.common.configure import Configure


@dataclasses.dataclass
class Tenant:
    """One module's share of the batch."""

    engine: BatchEngine      # per-module BatchEngine (provides the image)
    func_name: str
    args_lanes: List[np.ndarray]   # one array per param, [lanes] each
    lanes: int

    @property
    def inst(self):
        return self.engine.inst

    @property
    def img(self) -> DeviceImage:
        return self.engine.img


@dataclasses.dataclass
class Segment:
    """One tenant's contribution to a concatenated image, every array
    already rebased into the concatenated index spaces."""

    base: dict                 # per-index-space offsets of this tenant
    planes: dict               # cls/sub/a/b/c/imm_lo/imm_hi/op_id
    brt: np.ndarray
    tbl: np.ndarray
    ef: np.ndarray
    eoff: np.ndarray
    elen: np.ndarray
    dwords: np.ndarray
    doff: np.ndarray
    dlen: np.ndarray
    f_parts: dict              # f_entry/f_nparams/... (rebased)
    g_lo: np.ndarray
    g_hi: np.ndarray
    v128: np.ndarray
    advance: dict              # per-index-space sizes, for the next one


def build_segment(t: Tenant, off: dict) -> Segment:
    """Rebase one tenant's DeviceImage at the index-space offsets `off`
    (pc/func/glob/type/brt/table/v128/eseg/eflat/dseg/dbyte)."""
    img = t.img
    pc_b, fn_b, gl_b, ty_b = off["pc"], off["func"], off["glob"], off["type"]
    tbl_b = off["table"]
    base = dict(pc=pc_b, func=fn_b, glob=gl_b, type=ty_b, brt=off["brt"],
                table=tbl_b, eseg=off["eseg"], dseg=off["dseg"])
    a = img.a.copy()
    c = img.c.copy()
    cls = img.cls
    a[np.isin(cls, (CLS_BR, CLS_BRZ, CLS_BRNZ))] += pc_b
    a[np.isin(cls, (CLS_CALL, CLS_RETCALL, CLS_HOSTCALL, CLS_REFFUNC))] += \
        fn_b
    a[np.isin(cls, (CLS_GLOBAL_GET, CLS_GLOBAL_SET))] += gl_b
    is_ci = np.isin(cls, (CLS_CALL_INDIRECT, CLS_RETCALL_INDIRECT))
    a[is_ci] += ty_b
    c[is_ci] += tbl_b
    a[cls == CLS_BR_TABLE] += off["brt"]
    a[np.isin(cls, (CLS_VCONST, CLS_VSHUFFLE))] += off["v128"]
    # table ops address the tenant's slot [tbl_b, tbl_b + slot) of the
    # concatenated plane
    c[np.isin(cls, (CLS_TABLE_GET, CLS_TABLE_SET, CLS_TABLE_SIZE,
                    CLS_TABLE_GROW, CLS_TABLE_FILL, CLS_TABLE_COPY,
                    CLS_TABLE_INIT))] += tbl_b
    a[np.isin(cls, (CLS_TABLE_INIT, CLS_ELEM_DROP))] += off["eseg"]
    a[np.isin(cls, (CLS_MEMINIT, CLS_DATA_DROP))] += off["dseg"]
    # `b` carries over unchanged: table.grow's capacity and memory.grow's
    # page ceiling are the tenant's own
    planes = dict(cls=cls, sub=img.sub, a=a, b=img.b.copy(), c=c,
                  imm_lo=img.imm_lo, imm_hi=img.imm_hi, op_id=img.op_id)
    brt = img.br_table.copy()
    brt[:, 0] += pc_b
    # each tenant's table slot is its table_cap rows (grow room), so a
    # table.grow never reaches a neighbour's slot
    slot = max(int(img.table_cap or img.table0.shape[0]),
               img.table0.shape[0])
    tbl = np.zeros(slot, img.table0.dtype)
    tbl[:img.table0.shape[0]] = img.table0
    tbl[tbl != 0] += fn_b
    # segment snapshots: entries rebase with the function index space
    # (funcref domain), offsets with the flat concatenation
    ef = img.elem_flat.copy()
    ef[ef != 0] += fn_b
    f_parts = dict(f_entry=img.f_entry + pc_b, f_nparams=img.f_nparams,
                   f_nlocals=img.f_nlocals, f_nresults=img.f_nresults,
                   f_frame_top=img.f_frame_top, f_type=img.f_type + ty_b)
    advance = dict(pc=img.code_len, func=len(img.f_entry),
                   glob=img.globals_lo.shape[0],
                   type=int(img.f_type.max(initial=0)) + 1,
                   brt=img.br_table.shape[0], table=slot,
                   v128=img.v128.shape[0], eseg=img.elem_len.shape[0],
                   eflat=ef.shape[0], dseg=img.data_len.shape[0],
                   dbyte=4 * img.data_words.shape[0])
    return Segment(base=base, planes=planes, brt=brt, tbl=tbl, ef=ef,
                   eoff=img.elem_off + off["eflat"], elen=img.elem_len,
                   dwords=img.data_words, doff=img.data_off + off["dbyte"],
                   dlen=img.data_len, f_parts=f_parts, g_lo=img.globals_lo,
                   g_hi=img.globals_hi, v128=img.v128, advance=advance)


def concat_images(tenants: Sequence[Tenant], cache=None
                  ) -> Tuple[DeviceImage, list]:
    """Concatenate the tenants' DeviceImages into one image.  Returns
    (image, bases): bases[i] holds tenant i's index-space offsets
    (pc/func/glob/type/brt/table/eseg/dseg).  `cache` (an image store
    `SegmentCache`, or None) keeps the rebased segments: a segment is a
    pure function of its tenant's image and its offsets, so appending a
    module to a generation rebuilds only the new module's segment, and
    the image is the same as without a cache."""
    off = dict(pc=0, func=0, glob=0, type=0, brt=0, table=0, v128=0,
               eseg=0, eflat=0, dseg=0, dbyte=0)
    segments: List[Segment] = []
    for t in tenants:
        seg = cache.lookup(t.img, off) if cache is not None else None
        if seg is None:
            seg = build_segment(t, off)
            if cache is not None:
                cache.store(t.img, off, seg)
        segments.append(seg)
        for k, v in seg.advance.items():
            off[k] += v

    def cat(get):
        return np.concatenate([get(s) for s in segments])

    with_mem = [t.img for t in tenants if t.img.has_memory]
    image = DeviceImage(
        **{f: cat(lambda s, f=f: s.planes[f])
           for f in ("cls", "sub", "a", "b", "c", "imm_lo", "imm_hi",
                     "op_id")},
        br_table=cat(lambda s: s.brt),
        **{f: cat(lambda s, f=f: s.f_parts[f])
           for f in ("f_entry", "f_nparams", "f_nlocals", "f_nresults",
                     "f_frame_top", "f_type")},
        table0=cat(lambda s: s.tbl),
        globals_lo=cat(lambda s: s.g_lo), globals_hi=cat(lambda s: s.g_hi),
        mem_init=np.zeros(1, np.int32),       # per lane, in initial_state
        # the plane covers every tenant: the largest initial and largest
        # ceiling (each lane's pages and each grow's ceiling are its own)
        mem_pages_init=max((i.mem_pages_init for i in with_mem), default=0),
        mem_pages_max=max((i.mem_pages_max for i in with_mem), default=0),
        has_memory=bool(with_mem),
        max_local_zeros=max(t.img.max_local_zeros for t in tenants),
        code_len=off["pc"],
        v128=cat(lambda s: s.v128),
        has_simd=any(t.img.has_simd for t in tenants),
        # no tier-0 plane: every host call is served through its tenant
        t0kind=np.zeros(off["pc"], np.int32), t0_fdwrite_safe=False,
        elem_flat=cat(lambda s: s.ef), elem_off=cat(lambda s: s.eoff),
        elem_len=cat(lambda s: s.elen), data_words=cat(lambda s: s.dwords),
        data_off=cat(lambda s: s.doff), data_len=cat(lambda s: s.dlen),
        table_max=0, table_cap=off["table"], table_size_init=0,
        has_table_mut=any(t.img.has_table_mut for t in tenants),
        has_table_grow=any(t.img.has_table_grow for t in tenants))
    return image, [s.base for s in segments]


def entry_meta(inst, func_name: str, who: str):
    """(local function index, its lowered metadata) of a tenant's batch
    entry, with the entry guard (v128 signatures are refused)."""
    try:
        local = check_batch_entry(inst, func_name)
    except KeyError:
        raise KeyError(f"{who}: no exported function {func_name!r}") \
            from None
    except ValueError as e:
        raise ValueError(f"{who}: {e}") from None
    return local, inst.lowered.funcs[local]


class MultiTenantBatchEngine(BatchEngine):
    """One batch over the concatenation of several tenants' modules,
    built from per-module BatchEngines (each tenant's image reflects its
    own instance); lanes are given to the tenants contiguously, in
    order.  `lanes` (the multi-module engine's pool) defaults to the sum
    of the tenants' lanes."""

    def __init__(self, tenants: Sequence[Tenant],
                 conf: Optional[Configure] = None, device="cuda",
                 lanes: Optional[int] = None, segment_cache=None):
        if not tenants:
            raise ValueError("no tenants")
        self.tenants = list(tenants)
        self.conf = conf or Configure()
        self.cfg = self.conf.batch
        self.lanes = int(lanes) if lanes else \
            sum(t.lanes for t in self.tenants)
        self.device = resolve_device(device)
        self.inst = None  # no single instance: see resolve_func
        img, self.bases = concat_images(self.tenants, cache=segment_cache)
        self._func_owner = np.concatenate(
            [np.full(len(t.img.f_entry), ti, np.int64)
             for ti, t in enumerate(self.tenants)])
        self._tenant_slices = []
        lane0 = 0
        for t in self.tenants:
            self._tenant_slices.append(slice(lane0, lane0 + t.lanes))
            lane0 += t.lanes
        self._setup_image(img)

    def owner(self, k: int) -> int:
        """Index of the tenant that owns concatenated function `k`."""
        return int(self._func_owner[k])

    # host calls resolve a concatenated function index to the tenant's own
    def resolve_func(self, k: int):
        ti = self.owner(k)
        return self.tenants[ti].inst.funcs[k - self.bases[ti]["func"]]

    def mem_pages_max_of(self, k: int) -> int:
        return int(self.tenants[self.owner(k)].img.mem_pages_max)

    def _base_state(self, pc, sp, pages, stack_lo, stack_hi, g_lo, g_hi,
                    mem, a3) -> BatchState:
        """A BatchState from the per-lane entry planes (numpy [L] or
        [rows, L]) and the memory plane and table planes on the device."""
        cfg, L, dev = self.cfg, self.lanes, self.device
        D, CD = cfg.value_stack_depth, cfg.call_stack_depth

        def t(x):  # a copy: no two planes may share memory
            return torch.tensor(np.asarray(x, np.int32), device=dev)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        fuel0 = cfg.fuel_per_launch if cfg.fuel_per_launch is not None else 0
        simd = self.img.has_simd
        return BatchState(
            pc=t(pc), sp=t(sp), fp=zeros(L), opbase=t(sp),
            call_depth=zeros(L), trap=zeros(L), retired=zeros(L),
            fuel=torch.full((L,), int(fuel0), dtype=torch.int32, device=dev),
            mem_pages=t(pages), stack_lo=t(stack_lo), stack_hi=t(stack_hi),
            fr_ret_pc=zeros(CD, L), fr_fp=zeros(CD, L),
            fr_opbase=zeros(CD, L), glob_lo=t(g_lo), glob_hi=t(g_hi),
            mem=mem, stack_e2=zeros(D, L) if simd else None,
            stack_e3=zeros(D, L) if simd else None, **a3)

    def initial_state(self, func_idx=None, args_lanes=None) -> BatchState:
        """Every tenant's slice at its own entry, with its arguments, its
        memory and pages, and its table size."""
        L, img = self.lanes, self.img
        D = self.cfg.value_stack_depth
        stack_lo = np.zeros((D, L), np.int32)
        stack_hi = np.zeros((D, L), np.int32)
        pc = np.zeros(L, np.int32)
        sp = np.zeros(L, np.int32)
        pages = np.zeros(L, np.int32)
        tsize = np.zeros(L, np.int32)
        W = memory_words(img)
        mem = torch.zeros((W, L), dtype=torch.int32, device=self.device)
        for ti, t in enumerate(self.tenants):
            sl = self._tenant_slices[ti]
            local, meta = entry_meta(t.inst, t.func_name, f"tenant {ti}")
            pc[sl] = int(img.f_entry[local + self.bases[ti]["func"]])
            sp[sl] = meta.nlocals
            lo, hi = pack_lane_args(t.args_lanes, t.lanes, len(t.args_lanes))
            stack_lo[:lo.shape[0], sl] = lo
            stack_hi[:hi.shape[0], sl] = hi
            tsize[sl] = t.img.table_size_init
            if t.img.has_memory:
                pages[sl] = t.img.mem_pages_init
                n = min(t.img.mem_init.shape[0], W)
                mem[:n, sl] = torch.as_tensor(
                    t.img.mem_init[:n], device=self.device)[:, None]
        return self._base_state(
            pc, sp, pages, stack_lo, stack_hi,
            np.repeat(img.globals_lo[:, None], L, axis=1),
            np.repeat(img.globals_hi[:, None], L, axis=1), mem,
            self._a3_planes(tsize))

    def _a3_planes(self, tsize: np.ndarray,
                   patches: Optional[dict] = None) -> dict:
        """The table and segment planes of the concatenated image (the
        reference's `_r05_planes`): `tab` holds every tenant's slot,
        `tsize` is the per-lane table size; `patches` ({"tab" / "edrop" /
        "ddrop": (row0, column)}) writes a snapshot overlay's rows into
        every lane."""
        L, img = self.lanes, self.img
        out = {}
        for f, rows in a3_plane_rows(self.img).items():
            if f == "tsize":
                out[f] = np.asarray(tsize, np.int32)
                continue
            p = np.zeros((rows, L), np.int32)
            if f == "tab":
                n0 = min(img.table0.shape[0], rows)
                p[:n0] = img.table0[:n0, None]
            if patches and f in patches:
                row0, col = patches[f]
                n = min(col.shape[0], rows - row0)
                if n > 0:
                    p[row0:row0 + n] = col[:n, None]
            out[f] = p
        return {f: torch.as_tensor(v, device=self.device)
                for f, v in out.items()}

    def run_tenants(self, max_steps: int = 10_000_000) -> List[BatchResult]:
        """Run the whole mixed batch; one BatchResult per tenant."""
        arm(self)   # a fresh lane mapping a run (None: compaction off)
        state, total = self.run_from_state(self.initial_state(), 0,
                                           max_steps)
        return self.results_from_state(state, total)

    def results_from_state(self, state: BatchState, total: int
                           ) -> List[BatchResult]:
        """One BatchResult per tenant from a final state; a permutation
        of lane compaction crosses the tenants' slices, so the planes are
        put back in their lanes' order before the slices are taken."""
        nres = [entry_meta(t.inst, t.func_name, f"tenant {ti}")[1].nresults
                for ti, t in enumerate(self.tenants)]
        R = max(max(nres), 1)
        lo, hi, trap, retired = restore_mirrors(
            self.compactor, state.stack_lo[:R].cpu().numpy(),
            state.stack_hi[:R].cpu().numpy(), state.trap.cpu().numpy(),
            state.retired.cpu().numpy())
        out = []
        for sl, n in zip(self._tenant_slices, nres):
            out.append(BatchResult(
                results=decode_results(lo[:, sl], hi[:, sl], int(n)),
                trap=trap[sl], retired=retired[sl], steps=total))
        return out


class MultiModuleBatchEngine(MultiTenantBatchEngine):
    """The serving engine: many modules, any lane, any entry.

    It keeps the concatenated image, but its `initial_state` is
    lane-uniform for one engine-global function index: the owning
    module's entry, its memory and table size in every lane and the whole
    concatenated global plane at its initial values (a fresh request
    resets its lane's globals: fresh-instance semantics).  The serving
    layer's LaneRecycler captures its columns once per function.

    Entry names are `module:func` (`export_func_idx`); a bare name is a
    function of the first module, so a one-module engine behaves like a
    BatchEngine under the server.  `modules` is an ordered list of
    (name, inst, store); `lanes` the pool's width; `init_overlays` maps a
    module name to a snapshot overlay dict (`mem`, `mem_pages`,
    `glob_lo` / `glob_hi`, `tab`, `tsize`, `edrop`, `ddrop`) that
    replaces its template state, and `snapshot_counts` counts the lanes
    admitted onto one.  `engines` gives the modules' one-lane
    BatchEngines, in order (the gateway's registry keeps one a module),
    so that a generation lowers none of them again; else each is built
    here.  `segment_cache` is an image store `SegmentCache` for
    `concat_images`."""

    def __init__(self, modules: Sequence[Tuple[str, object, object]],
                 conf: Optional[Configure] = None,
                 lanes: Optional[int] = None, init_overlays=None,
                 snapshot_counts=None, device="cuda", engines=None,
                 segment_cache=None):
        if not modules:
            raise ValueError("no modules")
        names = [name for name, _, _ in modules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate module names in {names}")
        conf = conf or Configure()
        if engines is not None and len(engines) != len(modules):
            raise ValueError(f"{len(engines)} engines for {len(modules)} "
                             f"modules")
        tenants = []
        for k, (name, inst, store) in enumerate(modules):
            # the module's own image (only the image is used: lanes=1)
            eng = engines[k] if engines is not None else BatchEngine(
                inst, store=store, conf=conf, lanes=1, device=device)
            tenants.append(Tenant(engine=eng, func_name="", args_lanes=[],
                                  lanes=0))
        super().__init__(tenants, conf=conf, device=device,
                         lanes=int(lanes) if lanes else conf.batch.lanes,
                         segment_cache=segment_cache)
        self._init_overlays = dict(init_overlays) if init_overlays else {}
        self.snapshot_counts = snapshot_counts \
            if snapshot_counts is not None else {}
        self.module_names = names
        self._mod_index = {name: ti for ti, name in enumerate(names)}

    # -- the export_func_idx / func_nresults seam (serve/recycle.py) -------
    def export_func_idx(self, func_name: str) -> int:
        mod, sep, fn = func_name.partition(":")
        if not sep:
            mod, fn = self.module_names[0], func_name
        ti = self._mod_index.get(mod)
        if ti is None:
            raise KeyError(f"no registered module {mod!r}")
        try:
            local = check_batch_entry(self.tenants[ti].inst, fn)
        except KeyError:
            raise KeyError(f"no exported function {fn!r} in module "
                           f"{mod!r}") from None
        return local + self.bases[ti]["func"]

    def func_owner(self, func_idx: int) -> str:
        """The name of the module that owns an engine-global function."""
        return self.module_names[self.owner(func_idx)]

    def note_snapshot_install(self, func_idx: int, n: int) -> None:
        """Count `n` lanes admitted onto a snapshot overlay (only entries
        whose module carries one)."""
        if self.func_owner(func_idx) in self._init_overlays:
            self.snapshot_counts["installs"] = \
                self.snapshot_counts.get("installs", 0) + int(n)

    def exported_funcs(self, module: str) -> List[str]:
        return self.tenants[self._mod_index[module]].inst.func_names()

    # -- lane-uniform entry state (the recycler's template) ----------------
    def initial_state(self, func_idx: int = 0, args_lanes=None
                      ) -> BatchState:
        L, img = self.lanes, self.img
        ti = self.owner(func_idx)
        t, base = self.tenants[ti], self.bases[ti]
        meta = t.inst.lowered.funcs[func_idx - base["func"]]
        stack_lo, stack_hi = pack_lane_args(args_lanes or [], L,
                                            self.cfg.value_stack_depth)
        W = memory_words(img)
        col = np.zeros(W, np.int32)   # the memory column of every lane
        pages = 0
        if t.img.has_memory:
            pages = t.img.mem_pages_init
            n = min(t.img.mem_init.shape[0], W)
            col[:n] = t.img.mem_init[:n]
        g_lo = img.globals_lo.copy()
        g_hi = img.globals_hi.copy()
        tsize = t.img.table_size_init
        patches = None
        ov = self._init_overlays.get(self.module_names[ti])
        if ov is not None:
            # a snapshot overlay: its columns replace the module's template
            # (memory from row 0, globals, table and dropped flags into the
            # module's own rows)
            if ov.get("mem") is not None:
                n = min(ov["mem"].shape[0], W)
                col[:n] = ov["mem"][:n]
            if ov.get("mem_pages") is not None:
                pages = int(ov["mem_pages"])
            if ov.get("glob_lo") is not None:
                gb = base["glob"]
                g_lo[gb:gb + ov["glob_lo"].shape[0]] = ov["glob_lo"]
                g_hi[gb:gb + ov["glob_hi"].shape[0]] = ov["glob_hi"]
            patches = {}
            if ov.get("tab") is not None:
                # entries are funcidx + 1 (0 = null): rebased as table0 is
                tab = np.asarray(ov["tab"], np.int32).copy()
                tab[tab != 0] += base["func"]
                patches["tab"] = (base["table"], tab)
            if ov.get("tsize") is not None:
                tsize = int(ov["tsize"])
            for f, b in (("edrop", "eseg"), ("ddrop", "dseg")):
                if ov.get(f) is not None:
                    patches[f] = (base[b], np.asarray(ov[f], np.int32))
        mem = torch.as_tensor(col, device=self.device)[:, None] \
            .repeat(1, L).contiguous()
        return self._base_state(
            np.full(L, int(img.f_entry[func_idx]), np.int32),
            np.full(L, meta.nlocals, np.int32), np.full(L, pages, np.int32),
            stack_lo, stack_hi, np.repeat(g_lo[:, None], L, axis=1),
            np.repeat(g_hi[:, None], L, axis=1), mem,
            self._a3_planes(np.full(L, tsize, np.int32), patches))


def run_mixed(specs, conf: Optional[Configure] = None,
              max_steps: int = 10_000_000, device="cuda"
              ) -> List[BatchResult]:
    """specs = [(inst, store, func_name, args_lanes, lanes)]: builds the
    per-module BatchEngines, concatenates them, runs the batch and
    returns one BatchResult per tenant."""
    conf = conf or Configure()
    tenants = [Tenant(engine=BatchEngine(inst, store=store, conf=conf,
                                         lanes=lanes, device=device),
                      func_name=func_name, args_lanes=list(args_lanes),
                      lanes=lanes)
               for inst, store, func_name, args_lanes, lanes in specs]
    return MultiTenantBatchEngine(tenants, conf=conf, device=device) \
        .run_tenants(max_steps=max_steps)
