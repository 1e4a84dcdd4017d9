"""Decoder robustness of the port: every case of tests/test_robustness.py
run against both of qvz_tpu_torch's decoders, the device decode on the
CPU (``pipeline.decode.decode(..., device="cpu")``, whose column-major
QVZ2 lanes run K5's plain version) and the host decoder
(``pipeline.host.decode``), and the same corruptions on column-major QVZ2
containers with lanes (scripts/sanitize_torch.py's corpus, whose larger
form chip_smoke.py decodes on the card).

The rule for each corrupted input: the port's outcome is qvz_tpu's on the
same bytes (``qvz_tpu.pipeline.decode.decode``, its host decoder): both
raise ValueError, with the same message where tests/test_robustness.py
matches one, or both return equal arrays. Any other exception fails."""

import importlib.util
import pathlib
import re
import time

import numpy as np
import pytest
from qvz_tpu.constants import DISTORTION_MSE
from qvz_tpu.format import container_v2
from qvz_tpu.native import runtime as rt
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState
from qvz_tpu.pipeline import decode as jdec
from qvz_tpu.pipeline import encode as jenc

from qvz_tpu_torch.format import container as port_container
from qvz_tpu_torch.ops import decoder_device as dd
from qvz_tpu_torch.ops.distortion import make_matrix as port_matrix
from qvz_tpu_torch.ops.well import WellState as PortWell
from qvz_tpu_torch.pipeline import decode as pdec
from qvz_tpu_torch.pipeline import host

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "sanitize_torch", ROOT / "scripts" / "sanitize_torch.py")
sanitize = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sanitize)

DECODERS = {
    "lanes": lambda blob: pdec.decode(blob, device="cpu"),
    "host": host.decode,
}
decoders = pytest.mark.parametrize("decoder", sorted(DECODERS))


def _outcome(fn, blob):
    try:
        return "ok", fn(blob)
    except ValueError as e:
        return "ValueError", str(e)


def _same(decoder, blob, match=None):
    """The port's outcome on `blob` is qvz_tpu's; where `match`, both
    messages match it. Returns the outcome."""
    want = _outcome(jdec.decode, blob)
    got = _outcome(DECODERS[decoder], blob)
    assert got[0] == want[0], (got, want)
    if want[0] == "ok":
        assert np.array_equal(got[1], want[1])
    elif match is not None:
        assert re.search(match, want[1]) and re.search(match, got[1]), \
            (got[1], want[1])
    return got


@pytest.fixture(scope="module")
def containers():
    """tests/test_robustness.py's fixture: 400 x 20, v1 and QVZ2 at 3
    shards from qvz_tpu's host engine (the port's gives the same bytes)."""
    rng = np.random.default_rng(77)
    start = rng.integers(20, 45, size=(400, 1))
    steps = rng.integers(-3, 4, size=(400, 19))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    dist = make_matrix(DISTORTION_MSE)
    v1 = jenc.encode(data, dist, ratio=0.5, well_state=WellState.debug(),
                     use_jax=False, want_recon=False).compressed
    v2 = jenc.encode(data, dist, ratio=0.5, well_state=WellState.debug(),
                     use_jax=False, shards=3, want_recon=False).compressed
    for shards, blob in ((1, v1), (3, v2)):
        assert host.encode(data, port_matrix(DISTORTION_MSE), ratio=0.5,
                           well_state=PortWell.debug(), shards=shards,
                           want_recon=False).compressed == blob
    return v1, v2


@decoders
@pytest.mark.parametrize("cut", [5, 40, 137, -1])
def test_truncated_v1(containers, decoder, cut):
    v1, _ = containers
    got = _same(decoder, v1[:cut if cut > 0 else len(v1) // 2])
    assert got[0] == "ValueError"


@decoders
@pytest.mark.parametrize("cut", [10, 60, 300])
def test_truncated_v2(containers, decoder, cut):
    _, v2 = containers
    assert _same(decoder, v2[:cut])[0] == "ValueError"


# tests/test_robustness.py's cut points: every 7th byte up to 512 (the
# header, the codebook blocks, the file WELL state, the directory with
# its mid-state slices), and three in the payloads
_CUTS = [str(c) for c in range(1, 512, 7)] + ["len-1", "len/2", "len*3/4"]


@decoders
@pytest.mark.parametrize("cut", _CUTS)
def test_truncated_v2_everywhere(containers, decoder, cut):
    """Truncation at every region raises ValueError in both packages,
    never a native crash or another exception type."""
    _, v2 = containers
    assert len(v2) > 512
    n = {"len-1": len(v2) - 1, "len/2": len(v2) // 2,
         "len*3/4": len(v2) * 3 // 4}.get(cut) or int(cut)
    assert _same(decoder, v2[:n])[0] == "ValueError"


@decoders
def test_flipped_codebook_bytes_detected(containers, decoder):
    v1, _ = containers
    rng = np.random.default_rng(0)
    raised = 0
    for _ in range(12):
        bad = bytearray(v1)
        pos = int(rng.integers(9, min(len(v1), 400)))
        bad[pos] ^= 0xFF
        got = _same(decoder, bytes(bad))
        if got[0] == "ok":
            assert got[1].ndim == 2
        raised += got[0] == "ValueError"
    assert raised >= 1


@decoders
def test_v2_payload_corruption_detected(containers, decoder):
    """Flipping a payload byte of any shard gives the checksum error."""
    _, v2 = containers
    head = container_v2.parse(v2, blocks_len=None)
    tables = rt.tables_from_blocks(
        v2[container_v2.header_size():], head.cluster_count, head.columns)
    head = container_v2.parse(v2, blocks_len=tables.consumed)
    rng = np.random.default_rng(3)
    for s in head.shards:
        for _ in range(4):
            bad = bytearray(v2)
            pos = s.payload_off + int(rng.integers(0, s.payload_len))
            bad[pos] ^= 1 << int(rng.integers(0, 8))
            assert _same(decoder, bytes(bad), "checksum")[0] == "ValueError"


def test_v1_huge_line_count_warns():
    with pytest.warns(RuntimeWarning, match="uint32"):
        port_container.write_header(1, 100, 2**32 + 5)


@decoders
def test_empty_and_tiny_inputs(decoder):
    for blob in (b"", b"\x01\x00\x00"):
        assert _same(decoder, blob)[0] == "ValueError"


@decoders
def test_random_blob_fuzz(decoder, monkeypatch):
    """Random garbage: the same outcome in both packages (a ValueError in
    every case here), never a crash or a runaway decode."""
    monkeypatch.setenv("QVZ_TPU_MAX_DECODE_BYTES", str(50_000_000))
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 4000))
        blob = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert _same(decoder, blob)[0] == "ValueError"


@decoders
def test_header_corruption_fuzz(containers, decoder, monkeypatch):
    """Single-byte header, directory and block corruptions end quickly
    with qvz_tpu's outcome, never a hang on a runaway line count."""
    monkeypatch.setenv("QVZ_TPU_MAX_DECODE_BYTES", str(50_000_000))
    rng = np.random.default_rng(1)
    t0 = time.monotonic()
    for comp in containers:
        for _ in range(150):
            bad = bytearray(comp)
            pos = int(rng.integers(0, min(len(comp), 200)))
            bad[pos] = int(rng.integers(0, 256))
            _same(decoder, bytes(bad))
    assert time.monotonic() - t0 < 120, "corruption fuzz too slow"


@decoders
def test_max_decode_bytes_cap(containers, decoder, monkeypatch):
    """A container claiming more output than QVZ_TPU_MAX_DECODE_BYTES is
    refused before any decoding; at the exact size it decodes."""
    for comp in containers:
        want = jdec.decode(comp)
        monkeypatch.setenv("QVZ_TPU_MAX_DECODE_BYTES", str(want.size - 1))
        assert _same(decoder, comp, "QVZ_TPU_MAX_DECODE_BYTES")[0] \
            == "ValueError"
        monkeypatch.setenv("QVZ_TPU_MAX_DECODE_BYTES", str(want.size))
        assert _same(decoder, comp)[0] == "ok"


# -- the same corruptions on column-major QVZ2 containers with lanes -------

@pytest.fixture(scope="module")
def lane_corpus():
    """scripts/sanitize_torch.py's corpus at 1,200 x 12: shards 8 and 4,
    priming on and off, -c 1 and -c 3 (a 256-line warmup shard, so that
    so small an input primes)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host, "PRIME_WARMUP_LINES", 256)
        return dict(sanitize.corpus(1200, 12))


@decoders
@pytest.mark.parametrize("name", sanitize.corpus_names())
def test_lane_container_corruption(lane_corpus, decoder, name, monkeypatch):
    """Each corruption of a container with lanes has qvz_tpu's outcome
    (the checksum error where a payload byte flipped unchecked); through
    pipeline.decode it reaches the lane decoder's plain version exactly
    where the header, directory, checksums, warmup shard and cluster-id
    prologues pass on the host."""
    blob = lane_corpus[name]
    calls = []
    plain = dd.decode_lanes_reference

    def spy(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(dd, "decode_lanes_reference", spy)
    _same(decoder, blob, "checksum" if name.endswith(":flip-payload")
          else None)
    if decoder == "lanes":
        reaches = _outcome(lambda b: pdec.prepare_lanes(b, "cpu"),
                           blob)[0] == "ok"
        assert bool(calls) == reaches
        if name.endswith(("flip-rechecked-1", "short-rechecked",
                          "flip-state")):
            assert reaches


def test_lane_corpus_covers_the_plans(lane_corpus):
    """The corpus's base containers are column-major QVZ2 with lanes at
    each pinned shard count, primed and unprimed, -c 1 and -c 3."""
    seen = set()
    for name, blob in lane_corpus.items():
        if not name.endswith(":flip-state"):
            continue
        head = pdec._parse(blob)[0]
        assert head.order == container_v2.ORDER_COL
        seen.add((head.cluster_count, len(head.shards) - head.priming,
                  head.priming))
    assert seen == {(1, 8, 1), (1, 4, 0), (3, 4, 0), (3, 8, 1)}
