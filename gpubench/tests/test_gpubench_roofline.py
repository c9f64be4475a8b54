"""The B1 byte and compare count against a hand count on a tiny store."""
import torch

from harness.roofline import b1_counts, bound_s


def test_b1_counts_match_a_hand_count():
    PP, P, G, M, K, T, F = 2, 3, 5, 4, 3, 2, 6
    pol = torch.zeros((PP, P, G, M, K), dtype=torch.int32)
    pmask = torch.zeros((PP, P, G, M), dtype=torch.bool)
    src = torch.zeros((PP, T, G, F), dtype=torch.int32)
    emask = torch.zeros((PP, T, G, F), dtype=torch.bool)
    # parent 1: 2 embeddings in (0, g0), 1 in (1, g3); parent 2 unused
    pmask[0, 1, 0, :2] = True
    pmask[1, 1, 3, 0] = True
    pmask[0, 2, 1, :4] = True
    # triple 0: 3 occurrences in (0, g0), 2 in (1, g3), 1 in (1, g4)
    emask[0, 0, 0, :3] = True
    emask[1, 0, 3, :2] = True
    emask[1, 0, 4, 0] = True
    emask[0, 1, 2, :5] = True             # triple 1 unused
    # rows: [parent, stub, to, fwd, triple, valid]; the third is padding
    sched = torch.tensor([[1, 0, 0, 1, 0, 1],
                          [1, 1, 0, 1, 0, 1],
                          [2, 0, 0, 1, 1, 0]], dtype=torch.int32)
    nbytes, compares = b1_counts(sched, pol, pmask, src, emask).tolist()
    rows = 2
    want_bytes = (rows * 5 * 4                      # candidate rows
                  + 1 * PP * G * M                  # parent 1's mask rows
                  + 3 * K * 4                       # its 3 set embeddings
                  + 1 * PP * G * F                  # triple 0's mask rows
                  + 6 * 8                           # its 6 set occurrences
                  + rows * PP * (4 + 4 + 1 * 4))    # sup, emb, 1 word
    # per row: (0, g0) 2 x 3 + (1, g3) 1 x 2 = 8 compares
    assert nbytes == want_bytes
    assert compares == rows * 8
    assert bound_s(3.35e12, 0) == 1.0
    assert bound_s(0, 67e12) == 1.0
