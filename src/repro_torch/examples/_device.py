"""The examples' ``--device`` rule, the launchers': the card unless the
caller asks for the CPU, with no fallback."""
import torch


def resolve(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for --device {name} (pass "
                           f"--device cpu to run on the CPU)")
    return device


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
