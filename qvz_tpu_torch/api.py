"""Public library API of the port (counterpart of ``qvz_tpu.api``).

    import qvz_tpu_torch.api as qvz

    stats = qvz.compress("reads.qual", "reads.q", shards=0, device="cuda")
    qvz.decompress("reads.q", "reads.dec", device="cuda")

Compression runs the device QVZ2 encode (pipeline/encode.py), across
several devices with ``mesh=parallel.mesh.make_mesh(...)``, or with
``compress(..., hosts=N)`` the multi-host driver (parallel/multihost.py);
decompression the device QVZ2 decode (pipeline/decode.py), which sends
containers without lanes (v1, single-shard) to the port's host decoder.
"""

from __future__ import annotations

import os

import numpy as np

from qvz_tpu_torch.constants import (  # noqa: F401  (re-exported)
    DISTORTION_CUSTOM,
    DISTORTION_LORENTZ,
    DISTORTION_MANHATTAN,
    DISTORTION_MSE,
    MODE_FIXED,
    MODE_RATIO,
)
from qvz_tpu_torch.ops.distortion import make_matrix
from qvz_tpu_torch.ops.well import WellState


def _well(seed: bytes | None, debug: bool) -> WellState:
    """The WELL start state: 128 given bytes, the debug seed, or random
    (the helper of ``qvz_tpu.api``)."""
    if seed is not None:
        return WellState.from_bytes(seed)
    if debug:
        return WellState.debug()
    return WellState(np.frombuffer(os.urandom(128), dtype="<u4").tolist())


def compress_bytes(data: bytes, *, mode: int = MODE_RATIO,
                   ratio: float = 0.5, clusters: int = 1,
                   distortion: int = DISTORTION_MSE,
                   distortion_file: str | None = None,
                   cluster_threshold: float = 4.0,
                   shards: int = 1,
                   well_seed: bytes | None = None,
                   debug_seed: bool = False,
                   prime: bool = True,
                   device: str = "cuda",
                   **encode_kw):
    """Compress raw quality-file bytes into a container. Returns
    (container bytes, stats). shards=1, the default as in qvz_tpu, gives
    the reference-compatible v1 container; shards=0 picks the device lane
    count and N >= 2 pins it (QVZ2). encode_kw
    (reuse_blocks, verbose, mesh) go to pipeline.encode.encode, which
    refuses any other keyword, qvz_tpu's use_jax among them. The
    stats' phase_seconds add ``parse``, the text's parse into reads."""
    from qvz_tpu_torch.pipeline import encode as enc_mod
    from qvz_tpu_torch.spec.pipeline import load_quality_file
    from qvz_tpu_torch.utils.spans import span

    phases: dict = {}
    with span(phases, "parse"):
        reads = load_quality_file(data)
    out = enc_mod.encode(
        reads, make_matrix(distortion, path=distortion_file),
        n_clusters=clusters, mode=mode, ratio=ratio,
        cluster_threshold=cluster_threshold,
        well_state=_well(well_seed, debug_seed), shards=shards,
        want_recon=False, prime=prime, device=device, **encode_kw)
    out.stats.phase_seconds.update(phases)
    return out.compressed, out.stats


def decompress_bytes(container: bytes, device: str = "cuda") -> bytes:
    """Decompress a v1 or QVZ2 container to quality text."""
    from qvz_tpu_torch.pipeline import decode as dec_mod
    return dec_mod.decode(container, device=device).tobytes()


def compress(input_path: str, output_path: str, *, hosts: int = 1,
             **kwargs):
    """File-to-file compression; kwargs as compress_bytes, whose
    keywords it does not name go on to pipeline.encode.encode, as in
    qvz_tpu.api.compress. hosts=N > 1 runs the multi-host driver
    (parallel/multihost.py), byte-identical for the same shard count,
    which takes only compress_bytes's keywords. Returns stats (a dict
    with hosts > 1)."""
    if hosts > 1:
        from qvz_tpu_torch.parallel.multihost import encode_multihost
        mh_kw = dict(
            shards=kwargs.pop("shards", 0) or 0,
            n_clusters=kwargs.pop("clusters", 1),
            mode=kwargs.pop("mode", MODE_RATIO),
            ratio=kwargs.pop("ratio", 0.5),
            cluster_threshold=kwargs.pop("cluster_threshold", 4.0),
            well_state=_well(kwargs.pop("well_seed", None),
                             kwargs.pop("debug_seed", False)),
            dist_matrix=make_matrix(
                kwargs.pop("distortion", DISTORTION_MSE),
                path=kwargs.pop("distortion_file", None)),
            prime=kwargs.pop("prime", True),
            device=kwargs.pop("device", "cuda"))
        if kwargs:
            raise TypeError(f"compress(hosts={hosts}) takes no "
                            f"{sorted(kwargs)}")
        compressed, mh = encode_multihost(input_path, n_hosts=hosts,
                                          **mh_kw)
        with open(output_path, "wb") as f:
            f.write(compressed)
        return mh
    with open(input_path, "rb") as f:
        blob, stats = compress_bytes(f.read(), **kwargs)
    with open(output_path, "wb") as f:
        f.write(blob)
    return stats


def decompress(input_path: str, output_path: str,
               device: str = "cuda") -> int:
    """File-to-file decompression. Returns the number of lines."""
    from qvz_tpu_torch.pipeline import decode as dec_mod
    return dec_mod.decode_file_to_file(input_path, output_path,
                                       device=device)
