"""Constants of the QVZ bitstream format and algorithm (a copy of
``qvz_tpu.constants`` with the names the port uses).

These values define the on-disk container and coder geometry and must match
the reference exactly for bit parity (reference: include/qv_compressor.h:19,
include/pmf.h:11, include/lines.h:12-13, src/main.c:13, src/qv_stream.c:56,
include/cluster.h:9).
"""

# Size of the quality-score alphabet (Phred+33, printable ASCII '!'..'h').
ALPHABET_SIZE = 72

# Phred+33 offset applied to every symbol on disk.
PHRED_OFFSET = 33

# Arithmetic coder register width in bits (m); rescale bound r = 1 << (m-3).
ARITH_M = 22
ARITH_R = 1 << (ARITH_M - 3)

# Adaptive-model count increment per observed symbol.
ADAPTIVE_STEP = 8

# k-means iteration cap.
MAX_KMEANS_ITERATIONS = 1000

# Lines per block of the reference loader (k-means seeds address reads
# as (block, line)).
MAX_LINES_PER_BLOCK = 1_000_000

# Rate-control modes (reference: include/codebook.h:21-23).
MODE_RATIO = 0  # target entropy = H(input) * ratio, per context
MODE_FIXED = 1  # target entropy = ratio (bits/symbol), per context

# Distortion metric ids (reference: include/distortion.h).
DISTORTION_MSE = 1
DISTORTION_LORENTZ = 2
DISTORTION_MANHATTAN = 3
DISTORTION_CUSTOM = 4

# WELL-1024a debug seed used by the reference's `make debug` build
# (src/qv_stream.c:82): every state word is 0x55555555.
WELL_DEBUG_WORD = 0x55555555
