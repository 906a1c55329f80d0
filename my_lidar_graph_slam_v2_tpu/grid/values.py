"""Occupancy value codec: probability <-> u16 value <-> odds / log-odds.

Replicates the numeric contract of the reference
(``grid_map_new/grid_binary_bayes.hpp:162-195`` and
``grid_map_new/grid_values.hpp:12-80``):

* internal u16 value 0 = unknown; values [1, 65535] map linearly to
  probability [0.001, 0.999];
* Bayes update in odds space: ``value <- ProbToValue(OddsToProb(
  ValueToOdds(value) * odds_obs))`` with ``odds_hit = p/(1-p)`` for
  p_hit = 0.62 and p_miss = 0.46 by default.

The device-side maps store **log-odds (f32)** plus an observed mask instead of
u16, because the Bayes update is then a pure scatter-add and the per-scan
update becomes one dense fused op.  An unknown cell behaves as log-odds 0
(p = 0.5) on first observation, which reproduces the reference's
"initialize to the observation" rule exactly (OddsToProb(1 * odds_obs) ==
p_obs).  Log-odds are clipped to the probability range [0.001, 0.999],
matching the saturation of the u16 codec.
"""
from __future__ import annotations

import numpy as np

PROB_MIN = 1e-3
PROB_MAX = 1.0 - 1e-3
VALUE_MIN = 1
VALUE_MAX = 65535
UNKNOWN_VALUE = 0
UNKNOWN_PROB = 0.0

LOGODDS_MIN = float(np.log(PROB_MIN / (1.0 - PROB_MIN)))
LOGODDS_MAX = float(np.log(PROB_MAX / (1.0 - PROB_MAX)))


def prob_to_value(prob):
    """``ProbabilityToValue`` — ``grid_values.hpp:12-22`` (with saturation).

    The reference relies on platform saturation for out-of-range doubles;
    we clamp explicitly.
    """
    prob = np.asarray(prob, dtype=np.float64)
    v = VALUE_MIN + (prob - PROB_MIN) * (VALUE_MAX - VALUE_MIN) / (
        PROB_MAX - PROB_MIN
    )
    return np.clip(v, VALUE_MIN, VALUE_MAX).astype(np.uint16)


def value_to_prob(value):
    """``ValueToProbability`` — ``grid_values.hpp:24-36``; 0 -> unknown (0.0)."""
    value = np.asarray(value)
    p = PROB_MIN + (PROB_MAX - PROB_MIN) * (
        value.astype(np.float64) - VALUE_MIN
    ) / (VALUE_MAX - VALUE_MIN)
    return np.where(value == UNKNOWN_VALUE, UNKNOWN_PROB, p)


def prob_to_odds(prob):
    prob = np.asarray(prob, dtype=np.float64)
    return prob / (1.0 - prob)


def odds_to_prob(odds):
    odds = np.asarray(odds, dtype=np.float64)
    return odds / (1.0 + odds)


def prob_to_logodds(prob):
    prob = np.asarray(prob, dtype=np.float64)
    return np.log(prob / (1.0 - prob))


def logodds_to_prob(logodds):
    # Numerically stable sigmoid
    logodds = np.asarray(logodds, dtype=np.float64)
    return 1.0 / (1.0 + np.exp(-logodds))


def logodds_to_value(logodds, observed):
    """Quantize f32 log-odds + mask to the reference u16 codec."""
    prob = logodds_to_prob(logodds)
    v = prob_to_value(prob)
    return np.where(np.asarray(observed, bool), v, UNKNOWN_VALUE).astype(
        np.uint16
    )


def value_to_logodds(value):
    """u16 codec -> (logodds f32, observed mask)."""
    value = np.asarray(value)
    observed = value != UNKNOWN_VALUE
    prob = np.clip(value_to_prob(value), PROB_MIN, PROB_MAX)
    logodds = np.where(observed, prob_to_logodds(prob), 0.0)
    return logodds.astype(np.float32), observed
