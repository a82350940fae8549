"""Configure: proposal set, runtime limits and the batch knobs of the port.

A trimmed copy of `wasmedge_tpu/common/configure.py`: the proposal set
the loader and validator gate opcodes on, the host modules a VM
registers, the runtime limits the validator and the scalar engine read
(memory pages, call depth), the `Statistics` settings (instruction
counting, gas, timers), and the `BatchConfigure` knobs the CUDA
warp-interpreter and its host launch loop read, and the
`ServeConfigure` knobs of the serving layer and the `ImagestoreConfigure`
knobs of the gateway's image store.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Proposal(enum.Enum):
    ImportExportMutGlobals = "mutable-globals"
    NonTrapFloatToIntConversions = "nontrap-f2i"
    SignExtensionOperators = "sign-extension"
    MultiValue = "multi-value"
    BulkMemoryOperations = "bulk-memory"
    ReferenceTypes = "reference-types"
    SIMD = "simd"
    TailCall = "tail-call"
    MultiMemories = "multi-memories"
    Annotations = "annotations"
    Memory64 = "memory64"
    ExceptionHandling = "exception-handling"
    Threads = "threads"
    FunctionReferences = "function-references"

    @property
    def gate_name(self) -> str:
        return self.value


# Defaults match the reference (configure.h:175-183).
DEFAULT_PROPOSALS = frozenset(
    {
        Proposal.ImportExportMutGlobals,
        Proposal.NonTrapFloatToIntConversions,
        Proposal.SignExtensionOperators,
        Proposal.MultiValue,
        Proposal.BulkMemoryOperations,
        Proposal.ReferenceTypes,
        Proposal.SIMD,
    }
)


class HostRegistration(enum.Enum):
    """Host modules a VM registers before instantiation (the WASI one
    is in the port; the reference's wasmedge_process is not)."""

    Wasi = "wasi"


@dataclasses.dataclass
class RuntimeConfigure:
    max_memory_pages: int = 65536
    max_call_depth: int = 2048


@dataclasses.dataclass
class StatisticsConfigure:
    instr_counting: bool = False
    cost_measuring: bool = False
    time_measuring: bool = False
    cost_limit: int = (1 << 64) - 1


@dataclasses.dataclass
class BatchConfigure:
    """Knobs of the batch engine that the port reads."""

    lanes: int = 4096  # instances per card
    value_stack_depth: int = 1024  # 64-bit slots per lane
    call_stack_depth: int = 512  # frames per lane
    memory_pages_per_lane: int = 1  # 64 KiB pages of linear memory per lane
    # table.grow capacity cap per lane (like memory_pages_per_lane: a
    # static ceiling of the [table_cap, lanes] plane; grow beyond it
    # returns -1, which the spec allows at any size)
    table_elems_per_lane: int = 4096
    steps_per_launch: int = 1024  # interpreter steps per kernel launch
    fuel_per_launch: Optional[int] = None  # per-lane fuel budget (gas analog)
    # per-opcode gas weights, indexed by opcode id (the Statistics cost
    # table; None = flat 1 per instruction).  Read only with fuel on, and
    # only when a weight differs from 1 (batch/engine.py `cost_plane`)
    cost_table: Optional[tuple] = None
    # serve parked host calls by groups through the SoA-vectorized WASI
    # implementations (host/wasi/vectorized.py) instead of lane by lane
    vectorized_hostcalls: bool = True
    # Basic-block fusion in the warp-interpreter: straight-line runs of
    # pure stack ops compile into single handlers that keep
    # intermediates in registers (one dispatch per block instead of one
    # per instruction).  None = on; False falls back to the peephole
    # superinstructions (per-op dispatch for images with v128 ops).
    block_fusion: Optional[bool] = None
    # Linear memory behind the window cache (B4): each lane keeps two
    # windows of HBM_WINDOW_ROWS memory words (batch/memwin.py) in the
    # card's shared memory, and its loads and stores go through them.
    # None or True: the windows, for every image with a memory of at least
    # 2 * HBM_WINDOW_ROWS words; False: every access reads and writes the
    # [words, lanes] plane in global memory directly.  The JAX package's
    # rule (pallas_engine.py `_mem_mode`) takes the windows whenever they
    # give a larger lane block than a VMEM-resident slab; one page per lane
    # never fits on chip on either device, so at every geometry the port
    # runs that rule gives the windows.  False here is the plane read
    # directly, not a resident slab, which has no counterpart on the card.
    mem_hbm: Optional[bool] = None
    # Optimistic convergence (lane-0 decisions + canary validation at
    # commit points instead of per-instruction cross-lane reductions).
    # None = on; False forces the per-step-checked ("careful") kernel.
    # (The JAX field's comment, wasmedge_tpu/common/configure.py.)  Here a
    # warp of 32 lanes that starts a launch converged runs its lane 0's
    # decisions, validated at commit points and rolled back into the
    # careful per-lane loop of the same kernel when a lane disagreed
    # (csrc/optimistic.cuh, batch/optimistic.py).
    optimistic: Optional[bool] = None
    # --- tier-0 host calls (wasmedge_tpu/common/configure.py:195-211) ---
    # Tier 0: service pure WASI calls (clock_time_get / random_get /
    # sched_yield / proc_exit / fd_write-to-buffered-stdout) directly in
    # the kernel: they cost a dispatch slot, not a device<->host round
    # trip.  False parks every hostcall on the outcall channel.
    tier0_hostcalls: bool = True
    # Seed for the in-kernel counter-PRNG behind tier-0 random_get
    # (deterministic per (seed, lane, call, word)).  None (the default)
    # draws fresh entropy once per Configure, so guests get
    # unpredictable bytes run-to-run like the os.urandom-backed scalar
    # and tier-1 paths; set an explicit seed for reproducible runs.
    rng_seed: Optional[int] = None
    # Per-lane in-device stdout record buffer, in 4-byte words (tier-0
    # fd_write appends records here; the host drains them at flush
    # points).  Writes that would overflow the buffer park on the
    # tier-1 channel instead (after a flush they fit again).  At least 16.
    stdout_buffer_words: int = 2048
    # Max bytes of one tier-0 fd_write iovec / random_get request the
    # kernel services inline; longer requests park on tier 1.
    tier0_write_max: int = 256
    tier0_random_max: int = 64
    # --- divergence-aware lane compaction (batch/compact.py) ---
    # At launch boundaries, sort the live lanes by (function, divergence
    # score, pc) with one gather over every lane plane, dead lanes to the
    # tail; fixed-cohort runs also narrow the launch width to the live
    # prefix.  Off (the default) runs the uncompacted path: nothing is
    # read back, permuted or narrowed.  Results are bit-identical either
    # way for guests whose output does not depend on their lane index
    # (tier-0 random_get seeds its stream by the physical lane).
    compact: bool = False
    # At least this many launch boundaries between two compactions.
    compact_min_interval: int = 2
    # A sort fires only when the adjacent-key breaks it removes exceed
    # this fraction of the live lanes.
    compact_trigger: float = 0.05
    # Cost model: removable breaks x steps per launch must reach this
    # factor x lanes; 0 fires at every eligible boundary (tests).
    compact_cost_factor: float = 4.0
    # Narrow the launch width to the smallest power of two covering the
    # live prefix (fixed-cohort runs), never below the floor.
    compact_narrow: bool = True
    compact_width_floor: int = 64


@dataclasses.dataclass
class SupervisorConfigure:
    """Knobs of supervised batch execution (batch/supervisor.py), the JAX
    package's `SupervisorConfigure`: periodic checkpoints, retry with
    backoff from the newest good snapshot, and the degradation ladder
    (the CUDA engine as built, the same engine with per-op tables, and on
    an engine on the CPU only the gas-metered scalar engine);
    FailureRecords land in common/statistics.py.  The checkpoint
    directory and `resume` are parameters of `BatchSupervisor` and
    `VM.execute_batch`, not knobs.

    Left out: `use_kernel_tier`, since the port has one CUDA engine that
    both runs and checkpoints (the JAX package's separate kernel tier, the
    knob's subject, has no counterpart); `allow_scalar_tier`, since the
    scalar rung follows the engine's device (never under an engine on the
    card); and the mesh knobs (`use_shard_drive`, `max_device_retries`,
    `eject_devices`), which come with more than one card."""

    # --- checkpoint cadence (batch/checkpoint.py snapshots) ---
    # Take a checkpoint every N retired steps (slices land on
    # steps_per_launch boundaries).  None = no step cadence.
    checkpoint_every_steps: Optional[int] = None
    # ... or every S seconds of wall clock, whichever fires first.
    checkpoint_every_s: Optional[float] = None
    # Lineage depth: older snapshots beyond this count are pruned.  A
    # corrupt newest snapshot falls back to the next in the lineage.
    keep_checkpoints: int = 2
    # --- retry / backoff ---
    # Consecutive failed attempts (no forward progress) before the
    # current rung is abandoned and the run demotes a rung.
    max_retries: int = 3
    # Exponential backoff between retries: min(backoff_max_s,
    # backoff_base_s * backoff_factor**(attempt-1)).
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 2.0
    # --- per-lane quarantine ---
    # A failure attributed to a lane set (an exception carrying `.lanes`)
    # that repeats this many times quarantines those lanes: to the scalar
    # engine when the engine is on the CPU and the module has no host
    # imports, else terminated with ErrCode.Terminated.
    poison_lane_retries: int = 2
    # A lane still running after retiring this many instructions is
    # terminated (ErrCode.Terminated) and recorded as a "runaway".  None
    # disables the cap.
    lane_step_cap: Optional[int] = None


@dataclasses.dataclass
class ServeConfigure:
    """Knobs of the continuous-batching serving layer (serve/) that the
    port reads: a BatchServer holds a bounded request queue, installs
    queued requests into lanes and recycles each lane as soon as it
    retires, checkpoints its state and recovers from a failed launch.
    (The reference's autotune knobs come with the recorder.)"""

    # Bounded request queue: submit() beyond this many queued (not yet
    # admitted) requests is rejected with QueueSaturated (backpressure,
    # never a silent drop).
    queue_capacity: int = 65536
    # Per-request retired-instruction budget: a request still running
    # past it is terminated with CostLimitExceeded (the serving loop has
    # no max_steps to drain to).
    max_steps_per_request: int = 10_000_000
    # Checkpoint the serving state every N serving rounds (each round is
    # one steps_per_launch slice).  None = only on demand.  Where the
    # snapshots land is BatchServer's `checkpoint_dir` parameter.
    checkpoint_every_rounds: Optional[int] = None
    keep_checkpoints: int = 2
    # Retry budget for launch and serve failures before the server gives
    # up and fails the in-flight futures (each retry restores the newest
    # good checkpoint, else re-queues the in-flight requests from
    # scratch).
    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 2.0


@dataclasses.dataclass
class ImagestoreConfigure:
    """Knobs of the image store (imagestore/), the JAX package's
    `ImagestoreConfigure`: segmented generation images and pre-initialized
    lane snapshots, both off by default (the off configuration concatenates
    every segment inline and admits every lane through template init).

    The persistent compile cache needs an ahead-of-time image format the
    port does not have yet (ROADMAP A7.7): `compile_cache` is here so that
    a gateway refuses it; its directory comes with the tier."""

    # Memoize per-module image segments across generation builds: a swap
    # reuses every segment already built and builds only the new module's.
    segmented: bool = False
    # Not in the port yet (A7.7): a GatewayService refuses True.
    compile_cache: bool = False
    # Run a module's nullary _initialize / _start once at registration on
    # its one-lane engine, keep the post-init columns, and admit its lanes
    # from them instead of template init.
    snapshots: bool = False
    # Snapshot SwapStore spill directory (None = host memory only).
    snapshot_dir: Optional[str] = None
    # Step budget of the registration's init run; past it (or on a trap
    # or a host call) the module gets no snapshot.
    snapshot_init_max_steps: int = 2_000_000

    @property
    def active(self) -> bool:
        return self.segmented or self.compile_cache or self.snapshots


@dataclasses.dataclass
class Configure:
    proposals: set = dataclasses.field(
        default_factory=lambda: set(DEFAULT_PROPOSALS))
    host_registrations: set = dataclasses.field(default_factory=set)
    runtime: RuntimeConfigure = dataclasses.field(
        default_factory=RuntimeConfigure)
    statistics: StatisticsConfigure = dataclasses.field(
        default_factory=StatisticsConfigure)
    batch: BatchConfigure = dataclasses.field(default_factory=BatchConfigure)
    serve: ServeConfigure = dataclasses.field(default_factory=ServeConfigure)
    supervisor: SupervisorConfigure = dataclasses.field(
        default_factory=SupervisorConfigure)
    imagestore: ImagestoreConfigure = dataclasses.field(
        default_factory=ImagestoreConfigure)

    def add_proposal(self, p: Proposal) -> "Configure":
        self.proposals.add(p)
        return self

    def remove_proposal(self, p: Proposal) -> "Configure":
        self.proposals.discard(p)
        return self

    def has_proposal(self, p: Proposal) -> bool:
        return p in self.proposals

    def proposal_gates(self) -> frozenset:
        """Set of gate-name strings for loader/validator opcode gating."""
        return frozenset(p.gate_name for p in self.proposals)
