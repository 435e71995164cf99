"""Published peaks of one NVIDIA H100 SXM 80GB HBM3 at its 700 W power
limit and 1.98 GHz boost clock (NVIDIA's data sheet, dense rates): 132 SMs
x 128 fp32 lanes (67 TFLOP/s counting an FMA as two), x 16 SFU lanes, 495
TFLOP/s of dense tf32 on the tensor cores, 3.35 TB/s of HBM3. A card set
below 700 W runs below them under load, so every share of them is printed
with the card's power limit beside it."""

SMS = 132
CLOCK_HZ = 1.98e9
FP32_RATE = SMS * 128 * CLOCK_HZ   # fp32 instructions per second (33.45 T)
SFU_RATE = SMS * 16 * CLOCK_HZ     # SFU operations per second (4.18 T)
TC_RATE = 495e12                   # dense tf32 tensor-core flops per second
HBM_RATE = 3.35e12                 # bytes per second
# a share may pass 100% by this much (clock and counting slack) before the
# reading is refused as impossible
PEAK_SLACK = 1.05
