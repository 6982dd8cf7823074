"""The stored-block zstd codec (io.compression without zstandard): its
frames are valid zstd (zstandard decodes them), it decodes its own frames,
and it refuses compressed frames with a clear ImportError."""
import io

import pytest

from al26.io import compression


@pytest.fixture
def zstandard():
    return pytest.importorskip("zstandard")


@pytest.mark.parametrize("size", [0, 1, 1000, 128 * 1024, 300_000])
def test_raw_frames_round_trip(zstandard, size):
    data = bytes(range(256)) * (size // 256) + b"x" * (size % 256)
    frame = compression.compress_raw(data)
    assert compression._decode_stored(frame) == data
    assert zstandard.ZstdDecompressor().decompress(frame) == data


def test_stream_writer_without_zstandard(zstandard, monkeypatch):
    monkeypatch.setattr(compression, "_zstd", None)
    data = b"ubjson" * 50_000
    out = io.BytesIO()
    compression.compress_stream(io.BytesIO(data), out, len(data))
    frame = out.getvalue()
    assert frame == compression.compress_raw(data)
    assert compression.decompress(frame) == data
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert compression.codec() == "zstd raw blocks (stored)"


def test_compress_without_zstandard_writes_raw(monkeypatch):
    monkeypatch.setattr(compression, "_zstd", None)
    data = b"state" * 1000
    frame = compression.compress(data)
    assert frame == compression.compress_raw(data)
    assert compression.decompress(frame) == data


def test_compressed_frame_needs_zstandard(zstandard, monkeypatch):
    frame = zstandard.ZstdCompressor(level=8).compress(b"abc" * 10_000)
    monkeypatch.setattr(compression, "_zstd", None)
    with pytest.raises(ImportError, match="zstandard"):
        compression.decompress(frame)


def test_stored_decoder_reads_rle_and_concatenated_frames(zstandard):
    # an RLE block (type 1) of 5 bytes 'z', then a second (raw) frame
    rle = (compression._frame_header(5)
           + ((5 << 3) | (1 << 1) | 1).to_bytes(3, "little") + b"z")
    frames = rle + compression.compress_raw(b"tail")
    assert compression._decode_stored(frames) == b"zzzzztail"
    assert zstandard.ZstdDecompressor().decompress(rle) == b"zzzzz"


def test_zstandard_path_still_compresses(zstandard):
    data = b"0" * 100_000
    frame = compression.compress(data)
    assert len(frame) < len(data) // 10
    assert compression.decompress(frame) == data
