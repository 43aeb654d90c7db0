"""Deterministic synthetic data: token streams for LM training and a
NYC-taxi-like CSV for the paper's Table I queries.

Training batches are a pure function of (seed, step) — the fault-tolerance
contract: after any restart, batch `i` is bit-identical, so lease-chained
training replays exactly (Flint C3 applied to the input pipeline; no
shuffle-buffer state to checkpoint).
"""

from __future__ import annotations

import numpy as np


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int) -> dict:
    """Zipf-ish token batch, deterministic in (seed, step)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # mixture: frequent head tokens + uniform tail, mild docwise structure
    z = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    tokens = (z + rng.integers(0, 17, size=(batch, seq))) % vocab
    return {"tokens": tokens.astype(np.int32)}


def lm_batch_stream(seed: int, batch: int, seq: int, vocab: int,
                    start_step: int = 0):
    step = start_step
    while True:
        yield step, lm_batch(seed, step, batch, seq, vocab)
        step += 1


# --------------------------------------------------------------- taxi CSV

PAYMENT_TYPES = ["credit", "cash", "no charge", "dispute"]
# rough bounding boxes (lon, lat) for the paper's two query targets
GOLDMAN = (-74.0144, 40.7147, -74.0134, 40.7157)  # 200 West St
CITIGROUP = (-74.0122, 40.7197, -74.0112, 40.7207)  # 388 Greenwich St


def taxi_csv(n_rows: int, seed: int = 0) -> bytes:
    """pickup_dt, dropoff_dt, dropoff_lon, dropoff_lat, trip_miles,
    payment_type, tip, total, precip_mm, taxi_color"""
    rng = np.random.default_rng(seed)
    months = rng.integers(1, 13, n_rows)
    days = rng.integers(1, 29, n_rows)
    hours = rng.integers(0, 24, n_rows)
    mins = rng.integers(0, 60, n_rows)
    lon = rng.uniform(-74.03, -73.75, n_rows)
    lat = rng.uniform(40.60, 40.90, n_rows)
    # plant drop-offs at the two HQs so Q1/Q2 have non-trivial answers
    hq = rng.random(n_rows)
    gl = hq < 0.004
    cg = (hq >= 0.004) & (hq < 0.007)
    lon[gl] = rng.uniform(GOLDMAN[0], GOLDMAN[2], gl.sum())
    lat[gl] = rng.uniform(GOLDMAN[1], GOLDMAN[3], gl.sum())
    lon[cg] = rng.uniform(CITIGROUP[0], CITIGROUP[2], cg.sum())
    lat[cg] = rng.uniform(CITIGROUP[1], CITIGROUP[3], cg.sum())
    miles = np.round(rng.gamma(2.0, 1.6, n_rows), 2)
    pay = rng.choice(len(PAYMENT_TYPES), n_rows, p=[0.62, 0.35, 0.02, 0.01])
    tip = np.round(np.where(pay == 0, rng.gamma(2.0, 1.4, n_rows), 0.0), 2)
    total = np.round(3.0 + miles * 2.5 + tip, 2)
    precip = np.round(np.maximum(rng.normal(-2.0, 4.0, n_rows), 0.0), 1)
    color = rng.choice(["yellow", "green"], n_rows, p=[0.8, 0.2])

    rows = []
    for i in range(n_rows):
        pickup = (f"2015-{months[i]:02d}-{days[i]:02d} "
                  f"{hours[i]:02d}:{mins[i]:02d}:00")
        dropoff = (f"2015-{months[i]:02d}-{days[i]:02d} "
                   f"{(hours[i] + 1) % 24:02d}:{mins[i]:02d}:00")
        rows.append(
            f"{pickup},{dropoff},{lon[i]:.6f},{lat[i]:.6f},{miles[i]},"
            f"{PAYMENT_TYPES[pay[i]]},{tip[i]},{total[i]},{precip[i]},"
            f"{color[i]}")
    return ("\n".join(rows) + "\n").encode()
