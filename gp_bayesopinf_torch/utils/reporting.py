"""What the port's example, study and measurement scripts share: the
card's name and power limit, written beside every time they report, and
the matplotlib their figures need."""

import subprocess


def card_line(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or the
    device's name where it is no card."""
    if not str(device).startswith("cuda"):
        return f"{device} (no card)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def require_figures():
    """Import matplotlib with the Agg backend and return ``pyplot``; where
    matplotlib is missing, the ImportError names it."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            "figures need the 'matplotlib' package, which is not installed "
            "(pass --no-figures)"
        ) from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
