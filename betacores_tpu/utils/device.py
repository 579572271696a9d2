"""The accelerator a measurement runs on, and its published peak rates.

Every timing this repository reports comes from a GPU. A measurement path
calls ``require_gpu`` first, and a device missing from ``PEAKS`` is an
error, never a default.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet: dense rates (no sparsity) at the 700 W power
# limit. A card set below 700 W cannot hold its top clock under load, so
# report its power limit beside any share of these.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,          # outside the tensor cores
        "hbm_bytes_per_s": 3.35e12,
        "hbm_bytes": 80e9,
    },
}


def peaks(device_kind: str) -> dict:
    """Published peaks of ``device_kind`` (``jax.devices()[0].device_kind``)."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add them "
            f"to betacores_tpu/utils/device.py with their source") from None


def require_gpu():
    """JAX's first device, which must be a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform} "
            f"({dev.device_kind}); this measurement runs only on a GPU")
    return dev
