"""FASTA/FASTQ streaming reader (kseq equivalent, include/kseq.h).

Handles plain or gzip files, FASTA ('>') and FASTQ ('@') records, multi-line
sequences, and yields (name, seq, qual) like kseq: name is the first
whitespace-delimited token, qual is b"" for FASTA.
"""

from __future__ import annotations

import gzip
from typing import Iterator


def _open(path: str):
    f = open(path, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.seek(0)
        return gzip.open(f, "rb")
    f.seek(0)
    return f


def read_seqs(path: str) -> Iterator[tuple[str, bytes, bytes]]:
    with _open(path) as f:
        name = None
        seq_parts: list[bytes] = []
        line = f.readline()
        while line:
            line = line.rstrip(b"\r\n")
            if not line:
                line = f.readline()
                continue
            if line[:1] == b">":
                if name is not None:
                    yield name, b"".join(seq_parts), b""
                name = line[1:].split()[0].decode() if len(line) > 1 else ""
                seq_parts = []
                line = f.readline()
            elif line[:1] == b"@":
                if name is not None:  # pending FASTA record
                    yield name, b"".join(seq_parts), b""
                    name, seq_parts = None, []
                rname = line[1:].split()[0].decode() if len(line) > 1 else ""
                seq = f.readline().rstrip(b"\r\n")
                plus = f.readline()
                if not plus.startswith(b"+"):
                    raise ValueError(f"malformed FASTQ near {rname!r}")
                qual = f.readline().rstrip(b"\r\n")
                if len(qual) != len(seq):
                    raise ValueError("truncated quality string")  # kseq err -2
                yield rname, seq, qual
                line = f.readline()
            else:
                if name is None:
                    raise ValueError(f"unexpected line: {line[:40]!r}")
                seq_parts.append(line)
                line = f.readline()
        if name is not None:
            yield name, b"".join(seq_parts), b""


def batched(it, size: int):
    """Group an iterator into lists of at most `size`."""
    buf = []
    for x in it:
        buf.append(x)
        if len(buf) == size:
            yield buf
            buf = []
    if buf:
        yield buf


class NativeBatchReader:
    """Streaming batches straight from the native reader (native/
    fastq_reader.cpp): parse + normalize + encode + right-align in C++,
    yielding device-ready [lanes, L] int32 batches.

    Yields (names, qcodes, lengths) with lanes = batch_size * (2 if with_rc
    else 1); the last batch is zero-length-padded to the fixed lane count.
    Reads longer than max_read_len are truncated (a warning is printed).
    """

    def __init__(self, path: str, encode_table, batch_size: int,
                 with_rc: bool = False, normalize: bool = False,
                 max_read_len: int = 1024):
        import ctypes

        import numpy as np

        from rowbowt_tpu_torch.construct.sa import _load_native

        lib = _load_native()
        if lib is None or not hasattr(lib, "rbt_fq_next_batch"):
            raise RuntimeError("native reader unavailable")
        self._lib = lib
        self._np = np
        self._ct = ctypes
        lib.rbt_fq_open.restype = ctypes.c_void_p
        lib.rbt_fq_next_batch.restype = ctypes.c_int64
        self._h = lib.rbt_fq_open(path.encode())
        if not self._h:
            raise FileNotFoundError(path)
        self.batch_size = batch_size
        self.L = max_read_len
        self.with_rc = with_rc
        self.enc = np.ascontiguousarray(encode_table, dtype=np.int16)
        from rowbowt_tpu_torch.alphabet import _NTOA

        self.norm = (np.ascontiguousarray(_NTOA) if normalize
                     else np.arange(256, dtype=np.uint8))

    @staticmethod
    def available() -> bool:
        from rowbowt_tpu_torch.construct.sa import _load_native

        lib = _load_native()
        return lib is not None and hasattr(lib, "rbt_fq_next_batch")

    def __iter__(self):
        np, ctypes = self._np, self._ct
        mult = 2 if self.with_rc else 1
        lanes = self.batch_size * mult
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        while True:
            qc = np.full((lanes, self.L), -1, dtype=np.int32)
            lens = np.zeros(lanes, dtype=np.int32)
            name_buf = ctypes.create_string_buffer(self.batch_size * 256)
            name_off = np.full(self.batch_size, -1, dtype=np.int64)
            nread = self._lib.rbt_fq_next_batch(
                ctypes.c_void_p(self._h),
                ctypes.c_int64(self.batch_size), ctypes.c_int64(self.L),
                self.enc.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                self.norm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_int(1 if self.with_rc else 0),
                qc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                name_buf, ctypes.c_int64(len(name_buf)),
                name_off.ctypes.data_as(c_i64p),
            )
            if nread < 0:
                raise ValueError("FASTQ parse error (truncated record?)")
            if nread == 0:
                break
            names = [
                (ctypes.string_at(ctypes.addressof(name_buf) + int(o)).decode()
                 if o >= 0 else f"read{q}")
                for q, o in enumerate(name_off[:nread])
            ]
            # shrink L to the batch's max length, keeping right alignment
            mx = int(lens[: nread * mult].max()) if nread else 1
            Lp = 32
            while Lp < mx:
                Lp <<= 1
            yield names, np.ascontiguousarray(qc[:, self.L - Lp:]), lens
            if nread < self.batch_size:
                break

    def close(self):
        if self._h:
            self._lib.rbt_fq_close(self._ct.c_void_p(self._h))
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
