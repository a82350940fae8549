"""Per-VM WASI state: args/envs/preopens, capability fd table, exit code.

Mirrors the reference WASI::Environ + VINode/VFS + INode stack
(WasmEdge include/host/wasi/environ.h:38-1156, vinode.h:1-765,
inode.h:160-698) collapsed into one POSIX layer: each fd carries
{base rights, inheriting rights} capabilities checked before every
operation, guest paths resolve against preopened directory roots with
sandbox-escape prevention, and proc_exit records the exit code.
"""

from __future__ import annotations

import os
import stat as stat_mod
import time
from typing import Dict, List, Optional, Tuple

from wasmedge_tpu_torch.host.wasi.wasi_abi import (
    Errno,
    Fdflags,
    Filetype,
    Rights,
    from_oserror,
)


class WasiError(Exception):
    """Internal unwinding for WASI syscall failures; becomes an errno."""

    def __init__(self, errno: int):
        self.errno = errno


class WasiExit(Exception):
    """proc_exit: unwinds the whole execution with an exit code."""

    def __init__(self, code: int):
        self.code = code
        super().__init__(f"wasi proc_exit({code})")


class FdEntry:
    """One open descriptor with its capability set (environ.h fd table)."""

    __slots__ = ("kind", "os_fd", "sock", "rights_base", "rights_inheriting",
                 "fdflags", "preopen_name", "host_path", "dir_cache")

    def __init__(self, kind: str, os_fd: int = -1, sock=None,
                 rights_base: int = 0, rights_inheriting: int = 0,
                 fdflags: int = 0, preopen_name: Optional[str] = None,
                 host_path: Optional[str] = None):
        self.kind = kind  # "file" | "dir" | "stdio" | "socket" | "prestat-dir"
        self.os_fd = os_fd
        self.sock = sock
        self.rights_base = rights_base
        self.rights_inheriting = rights_inheriting
        self.fdflags = fdflags
        self.preopen_name = preopen_name  # guest-visible preopen path
        self.host_path = host_path
        self.dir_cache = None  # readdir snapshot


_NSEC = 1_000_000_000


def _filetype_of_mode(mode: int) -> int:
    if stat_mod.S_ISREG(mode):
        return Filetype.REGULAR_FILE
    if stat_mod.S_ISDIR(mode):
        return Filetype.DIRECTORY
    if stat_mod.S_ISLNK(mode):
        return Filetype.SYMBOLIC_LINK
    if stat_mod.S_ISCHR(mode):
        return Filetype.CHARACTER_DEVICE
    if stat_mod.S_ISBLK(mode):
        return Filetype.BLOCK_DEVICE
    if stat_mod.S_ISSOCK(mode):
        return Filetype.SOCKET_STREAM
    return Filetype.UNKNOWN


class WasiEnviron:
    """reference: WASI::Environ (init/fini, lib/host/wasi/environ.cpp)."""

    def __init__(self):
        self.args: List[str] = []
        self.envs: List[str] = []
        self.fds: Dict[int, FdEntry] = {}
        self.exit_code: int = 0
        self.exited: bool = False
        self._next_fd = 3

    # -- lifecycle (environ.h init/fini) -----------------------------------
    def init(self, dirs: Optional[List[str]] = None, prog_name: str = "wasm",
             args: Optional[List[str]] = None,
             envs: Optional[List[str]] = None):
        """dirs entries are "guest_path:host_path" or "path" (both sides
        equal) — the CLI --dir syntax (tools/wasmedge/wasmedger.cpp:41-47)."""
        self.args = [prog_name] + list(args or [])
        self.envs = list(envs or [])
        self.fds = {
            0: FdEntry("stdio", os_fd=0, rights_base=Rights.FD_READ
                       | Rights.FD_FDSTAT_SET_FLAGS | Rights.POLL_FD_READWRITE
                       | Rights.FD_FILESTAT_GET),
            1: FdEntry("stdio", os_fd=1, rights_base=Rights.FD_WRITE
                       | Rights.FD_FDSTAT_SET_FLAGS | Rights.POLL_FD_READWRITE
                       | Rights.FD_FILESTAT_GET),
            2: FdEntry("stdio", os_fd=2, rights_base=Rights.FD_WRITE
                       | Rights.FD_FDSTAT_SET_FLAGS | Rights.POLL_FD_READWRITE
                       | Rights.FD_FILESTAT_GET),
        }
        self._next_fd = 3
        self.exit_code = 0
        self.exited = False
        for spec in dirs or []:
            guest, sep, host = spec.partition(":")
            if not sep:
                host = guest
            self._add_preopen(guest or "/", host)

    def fini(self):
        for fd, e in list(self.fds.items()):
            if e.kind in ("file", "dir", "prestat-dir") and e.os_fd >= 0:
                try:
                    os.close(e.os_fd)
                except OSError:
                    pass
            if e.sock is not None:
                try:
                    e.sock.close()
                except OSError:
                    pass
        self.fds.clear()

    def _add_preopen(self, guest: str, host: str):
        fd = os.open(host, os.O_RDONLY | os.O_DIRECTORY)
        entry = FdEntry(
            "prestat-dir", os_fd=fd,
            rights_base=Rights.DIR_BASE,
            rights_inheriting=Rights.DIR_BASE | Rights.FILE_BASE,
            preopen_name=guest, host_path=os.path.realpath(host))
        self.fds[self._alloc_fd()] = entry

    def _alloc_fd(self) -> int:
        fd = self._next_fd
        while fd in self.fds:
            fd += 1
        self._next_fd = fd + 1
        return fd

    # -- fd helpers --------------------------------------------------------
    def get_fd(self, fd: int, required_rights: int = 0) -> FdEntry:
        e = self.fds.get(fd)
        if e is None:
            raise WasiError(Errno.BADF)
        if required_rights & ~e.rights_base:
            raise WasiError(Errno.NOTCAPABLE)
        return e

    def insert_entry(self, entry: FdEntry) -> int:
        fd = self._alloc_fd()
        self.fds[fd] = entry
        return fd

    def close_fd(self, fd: int):
        e = self.fds.pop(fd, None)
        if e is None:
            raise WasiError(Errno.BADF)
        try:
            if e.sock is not None:
                e.sock.close()
            elif e.kind != "stdio" and e.os_fd >= 0:
                os.close(e.os_fd)
        except OSError as ex:
            raise WasiError(from_oserror(ex))

    # -- path resolution (VINode::resolvePath analog) ----------------------
    def resolve_path(self, dirfd_entry: FdEntry, guest_path: str,
                     follow_final: bool = True) -> str:
        """Resolve a guest path against a preopened dir into a host path,
        refusing escapes (reference: lib/host/wasi/vinode.cpp path walk).

        Every intermediate symlink is resolved and re-checked against the
        sandbox root, so `a/../../x` and absolute/rooted symlinks cannot
        break out.

        Known limitation (TOCTOU): the walk is check-then-use over string
        paths — a component swapped for a symlink between this check and
        the caller's open() can escape the preopen. The reference walks
        with per-component openat()-style fds (lib/host/wasi/vinode.cpp);
        matching that here needs os.open(O_NOFOLLOW|O_DIRECTORY) dir_fd
        plumbing through every caller. Single-tenant CLI use (trusted
        host filesystem, untrusted guest) is unaffected; do not rely on
        this sandbox against an adversary that can mutate the preopened
        tree concurrently.
        """
        if dirfd_entry.host_path is None:
            raise WasiError(Errno.NOTDIR)
        root = dirfd_entry.host_path
        parts = [p for p in guest_path.split("/") if p not in ("", ".")]
        cur = root
        i = 0
        depth = 0
        last_was_dotdot = False
        while i < len(parts):
            if depth > 64:
                raise WasiError(Errno.LOOP)
            part = parts[i]
            if part == "..":
                if os.path.realpath(cur) == root:
                    raise WasiError(Errno.NOTCAPABLE)  # escape attempt
                cur = os.path.dirname(cur)
                last_was_dotdot = True
                i += 1
                continue
            nxt = os.path.join(cur, part)
            is_final = i == len(parts) - 1
            if os.path.islink(nxt) and (follow_final or not is_final):
                target = os.readlink(nxt)
                if target.startswith("/"):
                    raise WasiError(Errno.NOTCAPABLE)
                parts = target.split("/") + parts[i + 1:]
                parts = [p for p in parts if p not in ("", ".")]
                i = 0
                depth += 1
                continue
            cur = nxt
            last_was_dotdot = False
            i += 1
        # Final containment check. After a trailing ".." `cur` itself is the
        # already-walked target directory; otherwise the directory that will
        # contain the final component must be inside the root.
        if not parts:
            rp = root
        elif last_was_dotdot:
            rp = os.path.realpath(cur)
        else:
            rp = os.path.realpath(os.path.dirname(cur))
        if not (rp == root or rp.startswith(root + os.sep)):
            raise WasiError(Errno.NOTCAPABLE)
        return cur

    # -- clocks ------------------------------------------------------------
    @staticmethod
    def clock_time(clock_id: int) -> int:
        from wasmedge_tpu_torch.host.wasi.wasi_abi import Clockid

        if clock_id == Clockid.REALTIME:
            return time.time_ns()
        if clock_id == Clockid.MONOTONIC:
            return time.monotonic_ns()
        if clock_id == Clockid.PROCESS_CPUTIME_ID:
            return time.process_time_ns()
        if clock_id == Clockid.THREAD_CPUTIME_ID:
            return time.thread_time_ns()
        raise WasiError(Errno.INVAL)

    @staticmethod
    def clock_res(clock_id: int) -> int:
        from wasmedge_tpu_torch.host.wasi.wasi_abi import Clockid

        if clock_id in (Clockid.REALTIME, Clockid.MONOTONIC,
                        Clockid.PROCESS_CPUTIME_ID, Clockid.THREAD_CPUTIME_ID):
            return 1  # nanosecond clocks on linux
        raise WasiError(Errno.INVAL)

    # -- stat helpers ------------------------------------------------------
    @staticmethod
    def filestat_tuple(st: os.stat_result) -> Tuple[int, ...]:
        return (st.st_dev, st.st_ino, _filetype_of_mode(st.st_mode),
                st.st_nlink, st.st_size,
                st.st_atime_ns, st.st_mtime_ns, st.st_ctime_ns)
