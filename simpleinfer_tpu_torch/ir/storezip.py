"""Store-only (uncompressed) ZIP reader/writer for ``.pnnx.bin`` weight archives.

Behavioral equivalent of the reference's StoreZipReader/StoreZipWriter
(src/pnnx/storezip.h:24-74 and storezip.cpp): the reader
walks local file headers sequentially (it does NOT rely on the central
directory), builds a name -> (offset, size) index, and serves raw byte
reads; the writer emits store-method local file headers, a central
directory, and an end-of-central-directory record with CRC32 checksums.

A copy of simpleinfer_tpu/ir/storezip.py (numpy-free, framework-free);
its optional native index walker is the port's own host library
(simpleinfer_tpu_torch/host.py), so the port never imports the JAX
package.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

_LFH_SIG = 0x04034B50
_CDH_SIG = 0x02014B50
_EOCD_SIG = 0x06054B50
# zip64 markers, handled like the reference (storezip.cpp zip64 support)
_LFH64_EXTRA_ID = 0x0001
_DD_SIG = 0x08074B50


@dataclass
class _FileMeta:
    offset: int  # absolute offset of the file data (past LFH + name + extra)
    size: int  # uncompressed == compressed size (store method)


class StoreZipReader:
    """Sequential local-file-header walker, like StoreZipReader::open."""

    def __init__(self, path: str | None = None):
        self._fp = None
        self._index: dict[str, _FileMeta] = {}
        if path is not None:
            self.open(path)

    # archives larger than this try the native index walker first
    _NATIVE_THRESHOLD = 1 << 20

    def open(self, path: str) -> None:
        self.close()
        self._fp = open(path, "rb")
        if self._try_native_index(path):
            return
        fp = self._fp
        while True:
            sig_bytes = fp.read(4)
            if len(sig_bytes) < 4:
                break
            (sig,) = struct.unpack("<I", sig_bytes)
            if sig != _LFH_SIG:
                break  # reached central directory (or garbage): stop
            header = fp.read(26)
            if len(header) < 26:
                break
            (
                _ver,
                flag,
                method,
                _modtime,
                _moddate,
                _crc,
                csize,
                usize,
                name_len,
                extra_len,
            ) = struct.unpack("<HHHHHIIIHH", header)
            name = fp.read(name_len).decode("utf-8", errors="replace")
            extra = fp.read(extra_len)
            if method != 0:
                raise ValueError(
                    f"storezip: entry {name!r} uses compression method {method}; "
                    "only store (0) is supported"
                )
            size = usize
            # zip64: sizes live in the extra field
            if usize == 0xFFFFFFFF or csize == 0xFFFFFFFF:
                pos = 0
                while pos + 4 <= len(extra):
                    eid, esz = struct.unpack_from("<HH", extra, pos)
                    if eid == _LFH64_EXTRA_ID and esz >= 16:
                        usize64, _csize64 = struct.unpack_from("<QQ", extra, pos + 4)
                        size = usize64
                        break
                    pos += 4 + esz
            offset = fp.tell()
            self._index[name] = _FileMeta(offset=offset, size=size)
            fp.seek(size, 1)
            if flag & 0x08:  # data descriptor follows
                dd = fp.read(4)
                if len(dd) == 4 and struct.unpack("<I", dd)[0] == _DD_SIG:
                    fp.seek(12, 1)
                else:
                    fp.seek(8, 1)

    def _try_native_index(self, path: str) -> bool:
        """Index via the C library (csrc/si_host.cpp) when built and the
        archive is big enough to matter; False -> python walker."""
        import os

        try:
            if os.path.getsize(path) < self._NATIVE_THRESHOLD:
                return False
            from .. import host

            if not host.available():
                return False
            import mmap

            with mmap.mmap(self._fp.fileno(), 0,
                           access=mmap.ACCESS_READ) as mm:
                idx = host.storezip_index(bytes(mm))
            if not idx:
                return False
            for name, (off, size) in idx.items():
                self._index[name] = _FileMeta(offset=off, size=size)
            return True
        except Exception:
            self._index.clear()
            return False

    def namelist(self) -> list[str]:
        return list(self._index)

    def get_file_size(self, name: str) -> int:
        """Size of entry, 0 if absent (matches StoreZipReader::get_file_size)."""
        meta = self._index.get(name)
        return meta.size if meta is not None else 0

    def read_file(self, name: str) -> bytes:
        meta = self._index.get(name)
        if meta is None:
            raise KeyError(f"storezip: no such file {name!r}")
        self._fp.seek(meta.offset)
        data = self._fp.read(meta.size)
        if len(data) != meta.size:
            raise IOError(f"storezip: short read for {name!r}")
        return data

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None
        self._index.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StoreZipWriter:
    """Store-method zip writer (LFH + central dir + EOCD, CRC32)."""

    def __init__(self, path: str | None = None):
        self._fp = None
        self._entries: list[tuple[str, int, int, int]] = []  # name, crc, size, lfh_off
        if path is not None:
            self.open(path)

    def open(self, path: str) -> None:
        self.close()
        self._fp = open(path, "wb")
        self._entries = []

    def write_file(self, name: str, data: bytes) -> None:
        fp = self._fp
        raw = bytes(data)
        crc = zlib.crc32(raw) & 0xFFFFFFFF
        name_b = name.encode("utf-8")
        lfh_off = fp.tell()
        fp.write(struct.pack("<IHHHHHIIIHH", _LFH_SIG, 20, 0, 0, 0, 0, crc,
                             len(raw), len(raw), len(name_b), 0))
        fp.write(name_b)
        fp.write(raw)
        self._entries.append((name, crc, len(raw), lfh_off))

    def close(self) -> None:
        if self._fp is None:
            return
        fp = self._fp
        cd_start = fp.tell()
        for name, crc, size, lfh_off in self._entries:
            name_b = name.encode("utf-8")
            fp.write(struct.pack("<IHHHHHHIIIHHHHHII", _CDH_SIG, 20, 20, 0, 0,
                                 0, 0, crc, size, size, len(name_b), 0, 0, 0,
                                 0, 0, lfh_off))
            fp.write(name_b)
        cd_size = fp.tell() - cd_start
        n = len(self._entries)
        fp.write(struct.pack("<IHHHHIIH", _EOCD_SIG, 0, 0, n, n, cd_size,
                             cd_start, 0))
        fp.close()
        self._fp = None
        self._entries = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
