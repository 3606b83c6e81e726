"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).

Frozen copy of the constants of `chip_smoke.py` (`HBM_BYTES_PER_S`,
`FP32_FLOP_PER_S`); a roofline share is stated against these, with the
card's power limit beside it.
"""
HBM_BYTES_PER_S = 3.35e12      # HBM3
FP32_FLOP_PER_S = 67e12        # float32 outside the tensor cores
