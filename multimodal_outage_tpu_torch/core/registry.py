"""Hurricane case-study registry (reference lit.py:148-156)."""

from __future__ import annotations

import datetime
from typing import Dict

HURRICANES: Dict[str, datetime.date] = {
    "michael": datetime.date(2018, 10, 10),
    "ian": datetime.date(2022, 9, 26),
    "idalia": datetime.date(2023, 8, 30),
}

# Risk-map baseline months per event year (reference utils.py:262-269).
RISK_MONTHS: Dict[int, tuple] = {
    2018: (6, 7, 8),
    2022: (6, 7, 8),
    2023: (4, 5, 6),
}


def leave_one_out(test_case: str) -> tuple[dict, dict]:
    """Leave-one-hurricane-out protocol: (train_val_cases, test_cases)."""
    if test_case not in HURRICANES:
        raise ValueError(
            f"Unknown test case {test_case!r}; pick one of {sorted(HURRICANES)}"
        )
    train_val = {k: v for k, v in HURRICANES.items() if k != test_case}
    return train_val, {test_case: HURRICANES[test_case]}
