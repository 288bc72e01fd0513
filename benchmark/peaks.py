"""Published peaks per device, by `torch.cuda.get_device_name()`: NVIDIA's
data sheet for the H100 SXM at its 700 W limit (dense, no sparsity). A card
set below 700 W runs slower than these; the run prints its power limit."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,  # FLOP/s in bfloat16 on the tensor cores (the activations' type)
        "f32_flops": 67e12,  # FLOP/s in float32 outside the tensor cores
        "hbm_bytes": 3.35e12,  # bytes/s of HBM3
    },
}
