"""What the run knows of its cards: the look for them, their name, SM
count, maximum SM clock and power limit, and the peak of device memory."""

import subprocess

import torch


class NoCard(RuntimeError):
    pass


def require(count: int):
    """Raise NoCard unless `count` CUDA cards are present. Asks only the
    CUDA count, so no CUDA context is made here."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: this benchmark runs only on the card")
    have = torch.cuda.device_count()
    if have < count:
        raise NoCard(f"the cell needs {count} cards, {have} present")


def smi(fields: str) -> list:
    """nvidia-smi's values of `fields` for each card, as strings."""
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60, check=True)
    return [[v.strip() for v in line.split(",")]
            for line in res.stdout.strip().splitlines()]


def describe(device, count: int) -> dict:
    """The result's `device` object, and the SMs and maximum SM clock of
    `device` for the bound model."""
    props = torch.cuda.get_device_properties(device)
    row = smi("clocks.max.sm,power.limit")[torch.device(device).index or 0]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "power_limit_w": float(row[1]),
            "sms": props.multi_processor_count,
            "max_sm_clock_mhz": float(row[0])}
