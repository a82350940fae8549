"""Crash-safe file writes: a copy of `wasmedge_tpu/utils/fsio.py`.

One implementation of the temp-file-in-target-dir + os.replace pattern
(checkpoint snapshots, batch/checkpoint.py): the temp file on the
target's filesystem, fsync before publishing, the temp file removed on
failure.
"""

from __future__ import annotations

import os
import tempfile


def atomic_write_bytes(path, data: bytes, fsync: bool = True):
    """Write `data` to `path` so a crash mid-write can never leave a
    truncated file at the destination nor clobber a previous good one.
    The temp file lives in the target directory (os.replace must not
    cross filesystems); on any failure it is removed and the original
    destination is untouched."""
    path = os.fspath(path)
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix="." + os.path.basename(path),
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
