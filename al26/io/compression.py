"""zstd frames for checkpoints and yields (al26_nbody.py:320-345: level 8,
all threads).

`zstandard` is optional. With it, frames are compressed exactly as the
reference writes them. Without it, the writer emits valid zstd frames made
of Raw (stored) blocks (RFC 8878 §3.1.1.2) with the standard library, and
the reader decodes Raw and RLE blocks itself; a frame with compressed
blocks then raises ImportError. Either way `zstd -d`, `zstandard` and the
reference's post-processing read what is written here.
"""
from __future__ import annotations

import struct
import sys

try:
    import zstandard as _zstd
except ImportError:     # the stored-block codec below takes over
    _zstd = None

_MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50          # ..5F: skippable frames (ignored)
_BLOCK_MAX = 128 * 1024          # Block_Maximum_Size
_announced = False


def codec() -> str:
    """Name of the codec this process writes with."""
    return "zstandard" if _zstd is not None else "zstd raw blocks (stored)"


def _announce() -> None:
    """Say once per run which codec writes the files."""
    global _announced
    if not _announced:
        _announced = True
        print(f"# al26.io: writing zstd frames with {codec()}",
              file=sys.stderr)


def _frame_header(size: int) -> bytes:
    # Single_Segment_flag=1 (no window descriptor, window = content size),
    # Frame_Content_Size_flag=3 (8-byte content size), no checksum, no
    # dictionary: descriptor 0b1110_0000
    return struct.pack("<IBQ", _MAGIC, 0xE0, size)


def _raw_blocks(chunks, size: int):
    """Raw block headers + payload for `size` bytes arriving as `chunks`
    (each at most _BLOCK_MAX bytes)."""
    left = size
    if size == 0:
        yield struct.pack("<I", 1)[:3]           # one empty last block
        return
    for chunk in chunks:
        left -= len(chunk)
        last = 1 if left == 0 else 0
        yield struct.pack("<I", (len(chunk) << 3) | last)[:3]   # type 0
        yield chunk


def compress_raw(data: bytes) -> bytes:
    """One zstd frame of Raw (stored) blocks holding `data`."""
    data = bytes(data)
    chunks = (data[i:i + _BLOCK_MAX] for i in range(0, len(data), _BLOCK_MAX))
    return _frame_header(len(data)) + b"".join(_raw_blocks(chunks, len(data)))


def compress(data: bytes, level: int = 8, threads: int = -1) -> bytes:
    _announce()
    if _zstd is None:
        return compress_raw(data)
    c = _zstd.ZstdCompressor(threads=threads, level=level)
    return c.compress(data)


def compress_stream(ifh, ofh, size: int, level: int = 8) -> None:
    """File-to-file: one frame of `size` bytes read from `ifh`, with the
    content size in the frame header (what the reference's one-shot
    decompress needs, al26_nbody.py:335-345)."""
    _announce()
    if _zstd is not None:
        cctx = _zstd.ZstdCompressor(level=level, threads=-1)
        cctx.copy_stream(ifh, ofh, size=size)
        return
    ofh.write(_frame_header(size))
    chunks = iter(lambda: ifh.read(_BLOCK_MAX), b"")
    for piece in _raw_blocks(chunks, size):
        ofh.write(piece)


def _decode_stored(data: bytes) -> bytes:
    """Decode frames whose blocks are all Raw or RLE (what this module
    writes without zstandard)."""
    out = bytearray()
    pos = 0
    while pos < len(data):
        (magic,) = struct.unpack_from("<I", data, pos)
        if magic & 0xFFFFFFF0 == _SKIPPABLE:
            (n,) = struct.unpack_from("<I", data, pos + 4)
            pos += 8 + n
            continue
        if magic != _MAGIC:
            raise ValueError("not a zstd frame")
        fhd = data[pos + 4]
        pos += 5
        single = (fhd >> 5) & 1
        fcs_flag = fhd >> 6
        if not single:
            pos += 1                              # window descriptor
        pos += (0, 1, 2, 4)[fhd & 3]              # dictionary id
        pos += (single, 2, 4, 8)[fcs_flag]        # frame content size
        while True:
            hdr = int.from_bytes(data[pos:pos + 3], "little")
            pos += 3
            last, btype, bsize = hdr & 1, (hdr >> 1) & 3, hdr >> 3
            if btype == 0:                        # Raw
                out += data[pos:pos + bsize]
                pos += bsize
            elif btype == 1:                      # RLE
                out += data[pos:pos + 1] * bsize
                pos += 1
            else:
                raise ImportError(
                    "this zstd frame holds compressed blocks; install "
                    "zstandard (pip install zstandard) to read it")
            if last:
                break
        if (fhd >> 2) & 1:
            pos += 4                              # content checksum
    return bytes(out)


def decompress(data: bytes) -> bytes:
    if _zstd is not None:
        return _zstd.ZstdDecompressor().decompress(data)
    return _decode_stored(data)
