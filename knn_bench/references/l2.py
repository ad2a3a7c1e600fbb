"""Squared Euclidean distance, the score of metric "l2".

The key orders points nearest first (smaller is nearer), and it is the
score the index reports (d²). ``mm(a, b)`` is a · bᵀ in the caller's
precision; the norms are taken in the operands' own dtype.
"""

#: Gaps and errors are read against the true d² (a share of it).
RELATIVE = True


def keys(q, p, mm):
    """(m, k) queries, (nb, k) points -> (m, nb) d², the norm form."""
    return (q * q).sum(1)[:, None] + (p * p).sum(1)[None, :] - 2.0 * mm(q, p)


def pair_keys(q, p):
    """(m, k) queries, (m, K, k) points -> (m, K) d², the difference form."""
    d = p - q[:, None, :]
    return (d * d).sum(-1)


def score(key):
    return key


def score_key(score):
    """The key of a reported score (the inverse of ``score``)."""
    return score
