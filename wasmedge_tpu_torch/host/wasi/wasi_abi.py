"""WASI snapshot_preview1 ABI constants and struct layouts.

The reference vendors a witx-generated header (thirdparty/wasi/api.hpp,
see WasmEdge lib/host/wasi/wasifunc.cpp for usage). These are the
same wire-stable constants, transcribed from the public WASI preview1 spec.
All structs are little-endian, matching wasm linear memory.
"""

from __future__ import annotations

import struct


# -- errno ------------------------------------------------------------------
class Errno:
    SUCCESS = 0
    TOOBIG = 1          # 2BIG
    ACCES = 2
    ADDRINUSE = 3
    ADDRNOTAVAIL = 4
    AFNOSUPPORT = 5
    AGAIN = 6
    ALREADY = 7
    BADF = 8
    BADMSG = 9
    BUSY = 10
    CANCELED = 11
    CHILD = 12
    CONNABORTED = 13
    CONNREFUSED = 14
    CONNRESET = 15
    DEADLK = 16
    DESTADDRREQ = 17
    DOM = 18
    DQUOT = 19
    EXIST = 20
    FAULT = 21
    FBIG = 22
    HOSTUNREACH = 23
    IDRM = 24
    ILSEQ = 25
    INPROGRESS = 26
    INTR = 27
    INVAL = 28
    IO = 29
    ISCONN = 30
    ISDIR = 31
    LOOP = 32
    MFILE = 33
    MLINK = 34
    MSGSIZE = 35
    MULTIHOP = 36
    NAMETOOLONG = 37
    NETDOWN = 38
    NETRESET = 39
    NETUNREACH = 40
    NFILE = 41
    NOBUFS = 42
    NODEV = 43
    NOENT = 44
    NOEXEC = 45
    NOLCK = 46
    NOLINK = 47
    NOMEM = 48
    NOMSG = 49
    NOPROTOOPT = 50
    NOSPC = 51
    NOSYS = 52
    NOTCONN = 53
    NOTDIR = 54
    NOTEMPTY = 55
    NOTRECOVERABLE = 56
    NOTSOCK = 57
    NOTSUP = 58
    NOTTY = 59
    NXIO = 60
    OVERFLOW = 61
    OWNERDEAD = 62
    PERM = 63
    PIPE = 64
    PROTO = 65
    PROTONOSUPPORT = 66
    PROTOTYPE = 67
    RANGE = 68
    ROFS = 69
    SPIPE = 70
    SRCH = 71
    STALE = 72
    TIMEDOUT = 73
    TXTBSY = 74
    XDEV = 75
    NOTCAPABLE = 76


import errno as _os_errno

# host OSError.errno -> wasi errno
_ERRNO_MAP = {
    _os_errno.E2BIG: Errno.TOOBIG, _os_errno.EACCES: Errno.ACCES,
    _os_errno.EADDRINUSE: Errno.ADDRINUSE,
    _os_errno.EADDRNOTAVAIL: Errno.ADDRNOTAVAIL,
    _os_errno.EAFNOSUPPORT: Errno.AFNOSUPPORT,
    _os_errno.EAGAIN: Errno.AGAIN, _os_errno.EALREADY: Errno.ALREADY,
    _os_errno.EBADF: Errno.BADF, _os_errno.EBADMSG: Errno.BADMSG,
    _os_errno.EBUSY: Errno.BUSY, _os_errno.ECANCELED: Errno.CANCELED,
    _os_errno.ECHILD: Errno.CHILD, _os_errno.ECONNABORTED: Errno.CONNABORTED,
    _os_errno.ECONNREFUSED: Errno.CONNREFUSED,
    _os_errno.ECONNRESET: Errno.CONNRESET,
    _os_errno.EDEADLK: Errno.DEADLK, _os_errno.EDESTADDRREQ: Errno.DESTADDRREQ,
    _os_errno.EDOM: Errno.DOM, _os_errno.EDQUOT: Errno.DQUOT,
    _os_errno.EEXIST: Errno.EXIST, _os_errno.EFAULT: Errno.FAULT,
    _os_errno.EFBIG: Errno.FBIG, _os_errno.EHOSTUNREACH: Errno.HOSTUNREACH,
    _os_errno.EIDRM: Errno.IDRM, _os_errno.EILSEQ: Errno.ILSEQ,
    _os_errno.EINPROGRESS: Errno.INPROGRESS, _os_errno.EINTR: Errno.INTR,
    _os_errno.EINVAL: Errno.INVAL, _os_errno.EIO: Errno.IO,
    _os_errno.EISCONN: Errno.ISCONN, _os_errno.EISDIR: Errno.ISDIR,
    _os_errno.ELOOP: Errno.LOOP, _os_errno.EMFILE: Errno.MFILE,
    _os_errno.EMLINK: Errno.MLINK, _os_errno.EMSGSIZE: Errno.MSGSIZE,
    _os_errno.EMULTIHOP: Errno.MULTIHOP,
    _os_errno.ENAMETOOLONG: Errno.NAMETOOLONG,
    _os_errno.ENETDOWN: Errno.NETDOWN, _os_errno.ENETRESET: Errno.NETRESET,
    _os_errno.ENETUNREACH: Errno.NETUNREACH, _os_errno.ENFILE: Errno.NFILE,
    _os_errno.ENOBUFS: Errno.NOBUFS, _os_errno.ENODEV: Errno.NODEV,
    _os_errno.ENOENT: Errno.NOENT, _os_errno.ENOEXEC: Errno.NOEXEC,
    _os_errno.ENOLCK: Errno.NOLCK, _os_errno.ENOLINK: Errno.NOLINK,
    _os_errno.ENOMEM: Errno.NOMEM, _os_errno.ENOMSG: Errno.NOMSG,
    _os_errno.ENOPROTOOPT: Errno.NOPROTOOPT, _os_errno.ENOSPC: Errno.NOSPC,
    _os_errno.ENOSYS: Errno.NOSYS, _os_errno.ENOTCONN: Errno.NOTCONN,
    _os_errno.ENOTDIR: Errno.NOTDIR, _os_errno.ENOTEMPTY: Errno.NOTEMPTY,
    _os_errno.ENOTSOCK: Errno.NOTSOCK, _os_errno.ENOTSUP: Errno.NOTSUP,
    _os_errno.ENOTTY: Errno.NOTTY, _os_errno.ENXIO: Errno.NXIO,
    _os_errno.EOVERFLOW: Errno.OVERFLOW, _os_errno.EPERM: Errno.PERM,
    _os_errno.EPIPE: Errno.PIPE, _os_errno.EPROTO: Errno.PROTO,
    _os_errno.EPROTONOSUPPORT: Errno.PROTONOSUPPORT,
    _os_errno.EPROTOTYPE: Errno.PROTOTYPE, _os_errno.ERANGE: Errno.RANGE,
    _os_errno.EROFS: Errno.ROFS, _os_errno.ESPIPE: Errno.SPIPE,
    _os_errno.ESRCH: Errno.SRCH, _os_errno.ESTALE: Errno.STALE,
    _os_errno.ETIMEDOUT: Errno.TIMEDOUT, _os_errno.ETXTBSY: Errno.TXTBSY,
    _os_errno.EXDEV: Errno.XDEV,
}


def from_oserror(e: OSError) -> int:
    return _ERRNO_MAP.get(e.errno, Errno.IO)


# -- rights (capability bits) ----------------------------------------------
class Rights:
    FD_DATASYNC = 1 << 0
    FD_READ = 1 << 1
    FD_SEEK = 1 << 2
    FD_FDSTAT_SET_FLAGS = 1 << 3
    FD_SYNC = 1 << 4
    FD_TELL = 1 << 5
    FD_WRITE = 1 << 6
    FD_ADVISE = 1 << 7
    FD_ALLOCATE = 1 << 8
    PATH_CREATE_DIRECTORY = 1 << 9
    PATH_CREATE_FILE = 1 << 10
    PATH_LINK_SOURCE = 1 << 11
    PATH_LINK_TARGET = 1 << 12
    PATH_OPEN = 1 << 13
    FD_READDIR = 1 << 14
    PATH_READLINK = 1 << 15
    PATH_RENAME_SOURCE = 1 << 16
    PATH_RENAME_TARGET = 1 << 17
    PATH_FILESTAT_GET = 1 << 18
    PATH_FILESTAT_SET_SIZE = 1 << 19
    PATH_FILESTAT_SET_TIMES = 1 << 20
    FD_FILESTAT_GET = 1 << 21
    FD_FILESTAT_SET_SIZE = 1 << 22
    FD_FILESTAT_SET_TIMES = 1 << 23
    PATH_SYMLINK = 1 << 24
    PATH_REMOVE_DIRECTORY = 1 << 25
    PATH_UNLINK_FILE = 1 << 26
    POLL_FD_READWRITE = 1 << 27
    SOCK_SHUTDOWN = 1 << 28
    SOCK_OPEN = 1 << 29
    SOCK_CLOSE = 1 << 30
    SOCK_RECV = 1 << 31
    SOCK_SEND = 1 << 32
    SOCK_BIND = 1 << 33

    ALL = (1 << 34) - 1
    # Directory-vs-file splits per the preview1 spec's recommended sets.
    DIR_BASE = (PATH_CREATE_DIRECTORY | PATH_CREATE_FILE | PATH_LINK_SOURCE
                | PATH_LINK_TARGET | PATH_OPEN | FD_READDIR | PATH_READLINK
                | PATH_RENAME_SOURCE | PATH_RENAME_TARGET | PATH_FILESTAT_GET
                | PATH_FILESTAT_SET_SIZE | PATH_FILESTAT_SET_TIMES
                | FD_FILESTAT_GET | FD_FILESTAT_SET_TIMES | PATH_SYMLINK
                | PATH_REMOVE_DIRECTORY | PATH_UNLINK_FILE)
    FILE_BASE = (FD_DATASYNC | FD_READ | FD_SEEK | FD_FDSTAT_SET_FLAGS
                 | FD_SYNC | FD_TELL | FD_WRITE | FD_ADVISE | FD_ALLOCATE
                 | FD_FILESTAT_GET | FD_FILESTAT_SET_SIZE
                 | FD_FILESTAT_SET_TIMES | POLL_FD_READWRITE)


# -- misc enums -------------------------------------------------------------
class Filetype:
    UNKNOWN = 0
    BLOCK_DEVICE = 1
    CHARACTER_DEVICE = 2
    DIRECTORY = 3
    REGULAR_FILE = 4
    SOCKET_DGRAM = 5
    SOCKET_STREAM = 6
    SYMBOLIC_LINK = 7


class Fdflags:
    APPEND = 1 << 0
    DSYNC = 1 << 1
    NONBLOCK = 1 << 2
    RSYNC = 1 << 3
    SYNC = 1 << 4


class Oflags:
    CREAT = 1 << 0
    DIRECTORY = 1 << 1
    EXCL = 1 << 2
    TRUNC = 1 << 3


class Lookupflags:
    SYMLINK_FOLLOW = 1 << 0


class Whence:
    SET = 0
    CUR = 1
    END = 2


class Clockid:
    REALTIME = 0
    MONOTONIC = 1
    PROCESS_CPUTIME_ID = 2
    THREAD_CPUTIME_ID = 3


class Eventtype:
    CLOCK = 0
    FD_READ = 1
    FD_WRITE = 2


class Subclockflags:
    ABSTIME = 1 << 0


class Fstflags:
    ATIM = 1 << 0
    ATIM_NOW = 1 << 1
    MTIM = 1 << 2
    MTIM_NOW = 1 << 3


class Preopentype:
    DIR = 0


class Sdflags:  # sock_shutdown how
    RD = 1 << 0
    WR = 1 << 1


# -- struct packers ---------------------------------------------------------
def pack_prestat_dir(name_len: int) -> bytes:
    return struct.pack("<BxxxI", Preopentype.DIR, name_len)


def pack_fdstat(filetype: int, flags: int, rights_base: int,
                rights_inheriting: int) -> bytes:
    return struct.pack("<BxHxxxxQQ", filetype, flags,
                       rights_base & 0xFFFFFFFFFFFFFFFF,
                       rights_inheriting & 0xFFFFFFFFFFFFFFFF)


def pack_filestat(dev: int, ino: int, filetype: int, nlink: int, size: int,
                  atim: int, mtim: int, ctim: int) -> bytes:
    return struct.pack("<QQBxxxxxxxQQQQQ", dev & (2**64 - 1), ino & (2**64 - 1),
                       filetype, nlink, size, atim, mtim, ctim)


def pack_dirent(next_cookie: int, ino: int, namlen: int, dtype: int) -> bytes:
    return struct.pack("<QQIBxxx", next_cookie, ino & (2**64 - 1), namlen, dtype)


DIRENT_SIZE = 24
FILESTAT_SIZE = 64
FDSTAT_SIZE = 24
PRESTAT_SIZE = 8
EVENT_SIZE = 32
SUBSCRIPTION_SIZE = 48


def pack_event(userdata: int, error: int, etype: int,
               nbytes: int = 0, evflags: int = 0) -> bytes:
    return struct.pack("<QHBxxxxxQHxxxxxx", userdata, error, etype,
                       nbytes, evflags)
