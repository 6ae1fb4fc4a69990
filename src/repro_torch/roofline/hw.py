"""The target card's figures: one NVIDIA H100 SXM5 80GB ("NVIDIA H100
80GB HBM3"), the card ``roofline/kernel_tune.py`` models.

Datasheet figures come from NVIDIA's H100 Tensor Core GPU datasheet (SXM5
column) and the CUDA C++ Programming Guide's table for compute capability
9.0.  Measured figures come from ``chip_smoke.py`` phase 17
(``calibrate_tuner``), which measures them again on every run and logs
them beside these; each names the card and power limit it was taken on
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
"""

CARD = "NVIDIA H100 80GB HBM3"

# --- datasheet: H100 SXM5 80GB ---
HBM_BW = 3.35e12                # bytes/s, HBM3
F32_FLOPS = 67e12               # FP32 operations/s outside the tensor cores
SMS = 132                       # streaming multiprocessors
# --- datasheet: CUDA C++ Programming Guide, compute capability 9.0 ---
SMEM_PER_SM = 228 * 1024        # shared memory an SM, bytes
SMEM_PER_BLOCK = 227 * 1024     # the most one block may use
SMEM_RESERVED_PER_BLOCK = 1024  # the system's share of each resident block
REGS_PER_SM = 65536             # 32-bit registers an SM
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32
# --- datasheet: the roofline's figures (``roofline/analysis.py``); not
# measured on the card ---
# dense BF16 tensor-core rate, H100 datasheet, SXM5 column (its 1,979
# TFLOP/s is with 2:4 sparsity)
PEAK_FLOPS_BF16 = 989.4e12
# float32 products run on the FP32 cores: the port keeps TF32 off
PEAK_FLOPS_F32 = F32_FLOPS
# one direction of NVLink 4 (the datasheet's 900 GB/s counts both)
LINK_BW = 450e9
HBM_BYTES = 80 * 1024**3        # 80 GiB of HBM3

# --- measured by chip_smoke.py phase 17a (calibrate_tuner) on MEASURED_ON,
# on the SCALE 22 R-MAT store's largest tile (E = 1,058,944, R = 622,320) ---
MEASURED_ON = "NVIDIA H100 80GB HBM3, 700.00 W"
# device seconds of one fused call over 32 edges and rows: a launch and
# one row block
LAUNCH_S = 7.840e-06
# host seconds of one pipelined stack dispatch (gab.run_tile_stack of one
# small tile: the stack's copies, padded buffers and merge), beyond the
# kernel call inside it
STACK_DISPATCH_S = 294.19e-06
# device seconds a wave of row blocks costs beyond its bytes (the segment
# sum over 2^20 rows of one edge each; mean over the three block_r)
ROW_WAVE_S = 5.229e-06
# device seconds a hub costs its group beyond its bytes (two searches, the
# ring's fill, the meeting at the scratch): rows of 513 edges, H = 256
HUB_S = 20.31e-06
# device seconds an edge of the row launch's longest kept row costs (12
# bytes an edge): the slope of the fused BFS kernel's time (Q = 1, 256
# rows a block) over H on the largest tile, from H = 256 to 2048
EDGE_WARP_S = 15.03e-09
# the hubs of the largest R-MAT tile over the most its edge list can hold
# (E / 2H), at H = 256
HUB_SHARE = 0.1349
