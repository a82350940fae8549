"""DurableStore: the gateway's crash-survivable state (r13 tentpole).

Everything the r11 gateway kept only in process memory — which modules
are registered, which async 202 ids are still owed an answer — lands
on disk here, so `GatewayService(resume=True)` can rebuild the front
door after a crash without losing a single client-visible id:

  <state_dir>/
    modules/<sha256>.wasm     registered wasm bytes, content-addressed
                              (two tenants registering identical bytes
                              share one blob)
    manifest-<seq>.json       the module set + attribution (name,
                              sha256, tenant, source), the current
                              generation's serve-checkpoint directory,
                              and the cumulative restart count
    journal-<seq>.json        the async-request journal: every
                              accepted-but-unresolved request id with
                              its tenant/module/func/args/deadline,
                              plus a bounded durable RESULT CACHE of
                              recently resolved entries
    serve/gen-<n>/            the generation's BatchServer checkpoint
                              lineage (serve-*.npz, owned by
                              serve/server.py)

Manifest and journal are sequence-numbered snapshot files riding the
shared `batch/lineage.py` machinery: every write is a NEW member
(crash-atomic via utils/fsio.atomic_write_bytes), the newest-good
walk skips a corrupt/truncated newest on load, and the prune pass
bounds the directory.  Writes are full-state snapshots, not appends —
one torn write can never orphan the log.

Resume semantics per request state (the README table):

  resolved, in the result cache   replayed verbatim  (exactly-once)
  in flight at the last serve     adopted from the checkpoint lineage
  checkpoint                      and finished        (exactly-once
                                  from the snapshot's point of view;
                                  post-snapshot progress re-executes)
  accepted, not in a checkpoint   re-queued under the SAME id
                                  (at-least-once: the guest may have
                                  partially run before the crash)
  resolved but aged out of the    polls answer 404 with the distinct
  result cache                    "pruned" detail (the journaled
                                  max_id floor marks the id as
                                  issued-and-aged, never "unknown")

The `journal_write` fault seam (testing/faults.py) fires before every
manifest/journal write; a submit whose journal write faults is rejected
with a retryable DurabilityError — the gateway never issues a 202 id it
could not make durable.

A copy of `wasmedge_tpu/gateway/durable.py` over the port's lineage and
fsio, without `compile_cache_dir` (the persistent compile cache is
ROADMAP A7.7).  The port's server adopts a checkpoint holding a stopped
lane that the JAX load refuses (ROADMAP C14), so a resumed port gateway
may bring back in flight a request the JAX one re-queues: the results
are the same.
"""

from __future__ import annotations

import json
import os
import threading
from typing import List, Optional, Tuple

from wasmedge_tpu_torch.batch.lineage import Lineage
from wasmedge_tpu_torch.common.errors import ErrCode, WasmError
from wasmedge_tpu_torch.utils.fsio import atomic_write_bytes

FORMAT_VERSION = 1


class DurabilityError(WasmError):
    """A durable write (module blob, manifest, journal) failed.
    Retryable: the condition is environmental (full disk, injected
    fault), not a property of the request — the HTTP layer maps it to
    503 + Retry-After so a client re-submits against a recovered
    gateway."""

    retryable = True

    def __init__(self, msg: str = "gateway durable write failed"):
        super().__init__(ErrCode.ExecutionFailed, msg)
        self.retry_after_s = 1.0


def _resolved_entry(req) -> dict:
    """Durable result-cache record for a finalized GatewayRequest."""
    err = req.future.error
    out = {"id": req.id, "tenant": req.tenant, "func": req.func}
    if err is None:
        out["ok"] = True
        out["result"] = [int(c) for c in req.future.result(0)]
        return out
    from wasmedge_tpu_torch.serve.queue import DeadlineExceeded, ServeRejected

    if isinstance(err, DeadlineExceeded):
        kind = "deadline"
    elif isinstance(err, ServeRejected):
        kind = "lifecycle"
    else:
        kind = "trap" if isinstance(err, WasmError) else "error"
    out["ok"] = False
    out["err"] = {"kind": kind,
                  "code": int(getattr(err, "code", ErrCode.ExecutionFailed)),
                  "message": str(err)}
    return out


def resolved_error(entry: dict) -> BaseException:
    """Rebuild a replayable exception from a durable result-cache
    record, preserving the class the HTTP status mapping branches on
    (a deadline that 504'd before the crash must 504 after it)."""
    err = entry.get("err") or {}
    kind = err.get("kind", "error")
    code = ErrCode(err["code"]) if err.get("code") in \
        ErrCode._value2member_map_ else ErrCode.ExecutionFailed
    msg = err.get("message", "")
    if kind == "deadline":
        from wasmedge_tpu_torch.serve.queue import DeadlineExceeded

        return DeadlineExceeded(msg or "request deadline exceeded")
    if kind == "lifecycle":
        from wasmedge_tpu_torch.serve.queue import ServeRejected

        return ServeRejected(msg or "rejected by a previous gateway "
                                    "process")
    return WasmError(code, msg)


class DurableStore:
    """On-disk module store + async-request journal for one gateway.

    Thread-safe: HTTP handler threads journal submits concurrently; one
    lock serializes snapshot writes (each write is the FULL current
    state, so serialization is also what makes the newest file
    authoritative)."""

    def __init__(self, state_dir: str, faults=None, keep: int = 2,
                 result_cache: int = 256):
        self.dir = os.fspath(state_dir)
        self.modules_dir = os.path.join(self.dir, "modules")
        os.makedirs(self.modules_dir, exist_ok=True)
        self.faults = faults
        self.keep = max(int(keep), 1)
        self.result_cache = max(int(result_cache), 0)
        self._lock = threading.Lock()
        self._manifest = Lineage()
        self._manifest.install(Lineage.scan(self.dir,
                                            r"manifest-(\d+)\.json"))
        self._journal = Lineage()
        self._journal.install(Lineage.scan(self.dir,
                                           r"journal-(\d+)\.json"))
        # snapshot members that failed to parse on load (skipped by the
        # newest-good walk); surfaced through gateway health
        self.load_errors = 0

    # -- module blobs ------------------------------------------------------
    def save_module_bytes(self, sha256: str, data: bytes):
        """Content-addressed: an existing blob is already the bytes
        (sha-keyed), so re-registration of known content is free."""
        path = os.path.join(self.modules_dir, f"{sha256}.wasm")
        if os.path.exists(path):
            return
        self._fire("journal_write", kind="module", sha256=sha256)
        atomic_write_bytes(path, data)

    def module_bytes(self, sha256: str) -> bytes:
        with open(os.path.join(self.modules_dir, f"{sha256}.wasm"),
                  "rb") as f:
            return f.read()

    # -- snapshots ---------------------------------------------------------
    def write_manifest(self, modules: List[dict], generation: int,
                       serve_dir: str, restarts: int):
        """Persist the module set (written after every successful
        generation swap, before the 201 is returned — a crash between
        swap and manifest simply resumes the previous set, and the
        client never saw a 201 for the module that vanished)."""
        doc = {"format": FORMAT_VERSION, "generation": int(generation),
               "serve_dir": serve_dir, "restarts": int(restarts),
               "modules": list(modules)}
        self._write(self._manifest, "manifest", doc)

    def write_journal(self, unresolved: List[dict],
                      resolved: List[dict], max_id: int = 0,
                      min_id: int = 0):
        """Persist the request journal: every accepted-but-unresolved
        id, the bounded durable result cache (newest last; the depth
        cap is applied here so the on-disk cache can never outgrow the
        knob), and the id RANGE ever issued (`min_id`/`max_id`) — the
        resumed process's pruned-vs-never-issued window (min_id
        matters since r16: fleet id-space rebasing means a gateway's
        ids need not start anywhere near 1)."""
        doc = {"format": FORMAT_VERSION,
               "max_id": int(max_id),
               "min_id": int(min_id),
               "unresolved": list(unresolved),
               "resolved": list(resolved)[-self.result_cache:]}
        self._write(self._journal, "journal", doc)

    def _write(self, lineage: Lineage, stem: str, doc: dict):
        with self._lock:
            self._fire("journal_write", kind=stem)
            seq = lineage.next_seq()
            path = os.path.join(self.dir, f"{stem}-{seq:08d}.json")
            atomic_write_bytes(path, (json.dumps(doc) + "\n").encode())
            lineage.add(path, seq)
            lineage.prune(self.keep)

    def _fire(self, point: str, **ctx):
        if self.faults is not None:
            self.faults.fire(point, **ctx)

    # -- load (resume) -----------------------------------------------------
    def load(self) -> Tuple[Optional[dict], Optional[dict]]:
        """(manifest, journal) — each the newest member that parses,
        walked newest-first with corrupt members skipped and counted
        (the lineage contract; a half-written pre-atomic-era file can
        only cost one fallback, never the resume)."""
        return (self._load_one(self._manifest),
                self._load_one(self._journal))

    def _load_one(self, lineage: Lineage) -> Optional[dict]:
        def load(m):
            with open(m.path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict) or "format" not in doc:
                raise ValueError(f"not a gateway snapshot: {m.path}")
            return doc

        def bad(exc, m):
            self.load_errors += 1

        with self._lock:
            return lineage.walk_newest(load, bad)

    # -- serve checkpoint dirs ---------------------------------------------
    def serve_dir_for(self, generation: int) -> str:
        return os.path.join(self.dir, "serve", f"gen-{int(generation):06d}")

    def drop_serve_dir(self, path: str):
        """Best-effort removal of a drained generation's checkpoint
        lineage by path (the new generation checkpoints into its own
        dir; a failed delete never fails the gateway).  Refuses paths
        outside this store's serve/ tree."""
        import shutil

        root = os.path.abspath(os.path.join(self.dir, "serve"))
        if os.path.commonpath([root, os.path.abspath(path)]) != root:
            return
        shutil.rmtree(path, ignore_errors=True)
