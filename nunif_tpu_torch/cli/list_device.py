"""List the CUDA devices as ``i: <name> (cuda)`` (counterpart of
``nunif_tpu/cli/list_device.py``, which lists JAX's devices).  Exits 1
where CUDA is not available."""
import sys


def main(argv=None):
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    for i in range(torch.cuda.device_count()):
        print(f"{i}: {torch.cuda.get_device_name(i)} (cuda)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
