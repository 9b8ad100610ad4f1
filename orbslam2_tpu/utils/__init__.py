"""Small runtime helpers shared by the entry points: device selection, the
persistent compile cache, and batched device->host readback."""
import os
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing is
    set here. Otherwise the cache lives in the checkout (`.jax_cache`, listed
    in .gitignore): a fixed path, because the path is part of the cache key.
    Returns the directory in use."""
    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env:
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return env or str(DEFAULT_CACHE_DIR)


def select_platform(platform: str) -> None:
    """Pin JAX to `platform` ("gpu" or "cpu") before its first use. "gpu"
    makes JAX fail at start-up when no CUDA device is present; it never
    falls back to the CPU."""
    import jax
    names = {"gpu": "cuda", "cpu": "cpu"}
    if platform not in names:
        raise ValueError(f"--platform must be one of {sorted(names)}, "
                         f"got {platform!r}")
    jax.config.update("jax_platforms", names[platform])


def require_gpu(devices=None) -> dict:
    """The device check of every measurement entry point: the first device
    must be a GPU. Raises RuntimeError otherwise. Returns the device as JAX
    reports it (platform, device_kind, count)."""
    import jax
    if devices is None:
        try:
            devices = jax.devices()
        except Exception as e:  # JAX raises more than one type here
            raise RuntimeError(f"no accelerator: {e!r}") from e
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"a GPU is required, found platform {d.platform!r} "
            f"({d.device_kind}); nothing runs on the CPU here")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


# Published peaks by device_kind (NVIDIA H100 Tensor Core GPU data sheet,
# SXM part, dense rates, at the full 700 W power limit). A card set below
# that limit cannot hold its top clock, so every share computed against
# these is printed beside the card's power limit.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def device_peaks(device_kind: str) -> dict:
    """Peak rates of `device_kind`; a device not in the table is an error,
    never a default."""
    if device_kind not in DEVICE_PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"known: {sorted(DEVICE_PEAKS)}")
    return DEVICE_PEAKS[device_kind]


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card: the
    line every reported time is labelled with."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30).stdout
    return out.strip().splitlines()[0]


def fetch(*arrays):
    """Batched device->host readback: wait for the computation once, start
    all host copies asynchronously, then materialize, so the copies overlap
    instead of running one after another."""
    import jax
    import numpy as np
    jax.block_until_ready(arrays[0])
    for a in arrays:
        a.copy_to_host_async()
    return [np.asarray(a) for a in arrays]
