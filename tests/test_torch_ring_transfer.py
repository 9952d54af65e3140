"""A plain model of the ring kernel's carry transfer (K3's flag protocol).

``csrc/ring_binfold.cu`` runs the whole ring in one launch per rank: at hop
h each block folds its bins, waits until every block of the left neighbour
flagged the carry of transfer t_in = epoch * (ndev - 1) + h - 1 as arrived
in slot t_in % 2, waits until every block of the right neighbour flagged
slot t_out % 2 (t_out = t_in + 1) as freed of transfer t_out - 2, merges,
stores the merged rows into the right neighbour's slot t_out % 2 and then
flags arrived (right) and freed (left). Flags hold t + 1 and never go back,
so ring calls follow each other with no reset. The plan's scratch (the
pieces and segment counts) is double-buffered by the parity of the global
hop g = epoch * ndev + h: a block starts hop g once every block of its
rank finished hop g - 2, counted per parity (hop_done[g % 2] >= nb * g // 2).

``RingModel`` replays that protocol for ndev ranks of ``n_blocks`` blocks
as a state machine, one step of one block at a time, in orders a seeded
numpy scheduler picks (and an adversarial one that starves a rank), with
the blocks of a receiver reading rows in another partition than its
sender's blocks wrote them. It asserts that no slot row is overwritten
before its reader merged it and that every row a block merges holds the
transfer it expects, and the bins every rank ends with, after several ring
calls, equal the chain of ``ring_fold_reference`` hops, and their top-k
``ring_binfold_topk_virtual``'s. Without the freed wait, the starving
schedule reproduces the overrun that the JAX kernel's comment records
(graphem_rapids_tpu/parallel/ring_binfold.py, the ready_sem rule): a
sender one hop ahead stores into a slot its right neighbour has not merged
yet. With one count of finished hops for both parities, a block that ran
a hop ahead lets another start hop g while a third still uses hop g - 2's
scratch: the race the card's concurrent test caught, which the model
reproduces.

The kernel itself runs this protocol on the card in the tests marked
``cuda`` (virtual ranks on one card, their regions mapped as each other's
neighbours), which the card's machine runs without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_ring_transfer.py
"""

import numpy as np
import pytest
import torch

from graphem_rapids_torch.parallel import ring_binfold as trb

K = 5


class Overrun(AssertionError):
    """A store into a slot row its reader had not merged yet."""


class ScratchRace(AssertionError):
    """A block starting hop g while another still folds hop g - 2, whose
    parity scratch hop g reuses."""


def _inputs(ndev, S=13, E_loc=3000, d=2, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((S, d)).astype(np.float32))
    tiles = [torch.from_numpy(rng.standard_normal((E_loc, d)).astype(
        np.float32)) for _ in range(ndev)]
    return q, tiles


class RingModel:
    """ndev ranks of ``n_blocks`` blocks running ``calls`` ring calls of
    the kernel's protocol on the (S_loc, G * 128) bins of q against
    ``tiles``; ``freed_wait=False`` drops the sender's wait for the freed
    flags, ``parity_counts=False`` counts finished hops in one count."""

    def __init__(self, q, tiles, n_blocks, calls, rng, freed_wait=True,
                 parity_counts=True):
        self.ndev = ndev = len(tiles)
        T, G, n_super, R_pad, S_pad, S_loc, _ = trb._geometry(
            tiles[0].shape[0], q.shape[0], ndev, K, 0.95)
        qp = trb._padded_queries(q, S_pad)
        # folds[r][s]: rank r's tile folded into shard s's bins, ids global
        self.folds = [[trb.ring_fold_reference(
            qp[s * S_loc:(s + 1) * S_loc], tiles[r], None, r * R_pad, T, G,
            n_super) for s in range(ndev)] for r in range(ndev)]
        self.S_loc, self.R_pad, self.nb = S_loc, R_pad, n_blocks
        self.calls, self.freed_wait, self.rng = calls, freed_wait, rng
        self.parity_counts = parity_counts
        self.hop_done = np.zeros((ndev, 2), np.int64)
        self.in_hop = np.full((ndev, n_blocks), -1, np.int64)
        shape = (S_loc, G * 128)
        self.slots = [[(torch.zeros(shape), torch.zeros(shape,
                                                        dtype=torch.int32))
                       for _ in range(2)] for _ in range(ndev)]
        # the transfer each slot row holds and nobody merged yet (-1: none)
        self.held = np.full((ndev, 2, S_loc), -1, np.int64)
        self.arrived = np.zeros((ndev, 2, n_blocks), np.int64)
        self.freed = np.zeros((ndev, 2, n_blocks), np.int64)
        self.out = [[None] * ndev for _ in range(calls)]
        # each block's program counter: (call, hop, phase); phase 0 starts
        # the hop (its scratch), 1 merges (after the waits), 2 flags
        self.pc = [[(0, 0, 0)] * n_blocks for _ in range(ndev)]
        self.rows = {}
        self.partials = {}

    def _rows(self, r, c, h, b):
        """The rows block b of rank r merges and stores at (call, hop): a
        random partition for each (rank, call, hop), so that a receiver's
        blocks never read the rows its sender's blocks wrote, block by
        block."""
        key = (r, c, h)
        if key not in self.rows:
            perm = self.rng.permutation(self.S_loc)
            self.rows[key] = np.array_split(perm, self.nb)
        return self.rows[key][b]

    def transfers(self, c, h):
        t_in = c * (self.ndev - 1) + h - 1
        return t_in, t_in + 1

    def runnable(self, r, b):
        c, h, phase = self.pc[r][b]
        if c >= self.calls:
            return False
        if phase == 0:
            if h == 0 and c > 0 and any(pc[0] < c for pc in self.pc[r]):
                # a new launch starts when the rank's previous one has ended
                return False
            g = c * self.ndev + h
            if self.parity_counts:
                return self.hop_done[r, g % 2] >= self.nb * (g // 2)
            return g < 2 or self.hop_done[r].sum() >= self.nb * (g - 1)
        if phase == 2:
            return True
        t_in, t_out = self.transfers(c, h)
        if h > 0 and (self.arrived[r, t_in % 2] < t_in + 1).any():
            return False
        if (self.freed_wait and h < self.ndev - 1 and t_out >= 2
                and (self.freed[r, t_out % 2] < t_out - 1).any()):
            return False
        return True

    def step(self, r, b):
        c, h, phase = self.pc[r][b]
        ndev = self.ndev
        t_in, t_out = self.transfers(c, h)
        right, left = (r + 1) % ndev, (r - 1) % ndev
        g = c * ndev + h
        if phase == 0:
            if g >= 2 and (self.in_hop[r] == g - 2).any():
                raise ScratchRace(f"rank {r} block {b} starts hop {g} while "
                                  f"a block still folds hop {g - 2}")
            self.in_hop[r, b] = g
            self.pc[r][b] = (c, h, 1)
            return
        if phase == 1:
            rows = torch.from_numpy(self._rows(r, c, h, b))
            s = (r - h) % ndev
            fv, fi = self.folds[r][s]
            fv, fi = fv[rows], fi[rows]
            if h > 0:
                held = self.held[r, t_in % 2, rows.numpy()]
                assert (held == t_in).all(), (r, c, h, held, t_in)
                self.held[r, t_in % 2, rows.numpy()] = -1
                cv, ci = (x[rows] for x in self.slots[r][t_in % 2])
                take = fv < cv
                fv, fi = torch.where(take, fv, cv), torch.where(take, fi, ci)
            if h < ndev - 1:
                dst = self.slots[right][t_out % 2]
                held = self.held[right, t_out % 2, rows.numpy()]
                if (held != -1).any():
                    raise Overrun(f"rank {r} stores transfer {t_out} into "
                                  f"rank {right}'s slot {t_out % 2}, which "
                                  f"still holds transfer {held.max()}")
                dst[0][rows], dst[1][rows] = fv, fi
                self.held[right, t_out % 2, rows.numpy()] = t_out
            else:
                self.partials.setdefault((r, c), []).append((rows, fv, fi))
            self.pc[r][b] = (c, h, 2)
            return
        self.in_hop[r, b] = -1
        self.hop_done[r, g % 2] += 1
        if h < ndev - 1:
            self.arrived[right, t_out % 2, b] = t_out + 1
        if h > 0:
            self.freed[left, t_in % 2, b] = t_in + 1
        if h + 1 < ndev:
            self.pc[r][b] = (c, h + 1, 0)
        else:
            self.pc[r][b] = (c + 1, 0, 0)
            if all(pc[0] > c for pc in self.pc[r]):
                shape = self.folds[0][0][0].shape
                v = torch.empty(shape)
                i = torch.empty(shape, dtype=torch.int32)
                for rows, fv, fi in self.partials.pop((r, c)):
                    v[rows], i[rows] = fv, fi
                self.out[c][r] = (v, i)

    def run(self, pick):
        """Steps until every block finished every call; ``pick`` chooses
        one of the runnable (rank, block) pairs."""
        while True:
            ready = [(r, b) for r in range(self.ndev) for b in range(self.nb)
                     if self.runnable(r, b)]
            if not ready:
                done = all(pc[0] >= self.calls for pcs in self.pc
                           for pc in pcs)
                assert done, f"deadlock at {self.pc}"
                return self.out
            self.step(*pick(ready))


def _chain(model, s):
    """Shard s's bins after the whole ring: its hops over the ranks s, s+1,
    ... merged by ring_fold_reference's rule (the carry wins ties)."""
    carry = None
    for h in range(model.ndev):
        fv, fi = model.folds[(s + h) % model.ndev][s]
        if carry is not None:
            take = fv < carry[0]
            fv, fi = torch.where(take, fv, carry[0]), torch.where(
                take, fi, carry[1])
        carry = (fv, fi)
    return carry


def _check(model, q, tiles, out):
    ndev = model.ndev
    want_v, want_i, _ = trb.ring_binfold_topk_virtual(q, tiles, K)
    for c in range(model.calls):
        for r in range(ndev):
            cv, ci = _chain(model, (r + 1) % ndev)
            assert torch.equal(out[c][r][0], cv)
            assert torch.equal(out[c][r][1], ci)
        top = [trb._top_bins(*out[c][(s - 1) % ndev], K) for s in range(ndev)]
        vals = torch.cat([v for v, _ in top])[:q.shape[0]]
        idx = torch.cat([i for _, i in top])[:q.shape[0]]
        assert torch.equal(vals, want_v)
        assert torch.equal(torch.sort(idx, 1).values,
                           torch.sort(want_i, 1).values)


@pytest.mark.fast
@pytest.mark.parametrize("ndev", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", range(4))
def test_random_interleavings_keep_every_carry(ndev, seed):
    """Random schedules of 3 blocks a rank over 3 ring calls: no overrun,
    every merge reads its own transfer, the bins are the ring's."""
    q, tiles = _inputs(ndev, seed=seed)
    rng = np.random.default_rng(100 + seed)
    model = RingModel(q, tiles, n_blocks=3, calls=3, rng=rng)
    out = model.run(lambda ready: ready[rng.integers(len(ready))])
    _check(model, q, tiles, out)


def _starving(slow):
    """Always the first runnable block of a rank other than ``slow``; the
    slow rank moves only when nothing else can."""
    def pick(ready):
        fast = [rb for rb in ready if rb[0] != slow]
        return (fast or ready)[0]
    return pick


@pytest.mark.fast
@pytest.mark.parametrize("ndev", [3, 4, 5])
def test_starved_rank_holds_its_left_neighbour(ndev):
    """A rank that moves only when no other can: its left neighbour runs a
    hop ahead and waits for the freed flags before it stores into the
    starved rank's slot again."""
    q, tiles = _inputs(ndev, seed=7)
    model = RingModel(q, tiles, n_blocks=2, calls=2,
                      rng=np.random.default_rng(7))
    _check(model, q, tiles, model.run(_starving(slow=1)))


@pytest.mark.fast
@pytest.mark.parametrize("ndev", [3, 4])
def test_one_count_of_finished_hops_races_the_scratch(ndev):
    """Block 1 of rank 0 stalls inside hop 0 while block 0 runs on: with
    one count of finished hops for both parities, block 0's hops 0 and 1
    reach the count hop 2 waits for, and block 0 starts hop 2 on the
    scratch block 1 still folds hop 0 in. Counted per parity, block 0
    waits. (A ring of one or two ranks cannot race: its hop 2 is the next
    launch, which starts when every block has finished.)"""
    def pick_for(model):
        def pick(ready):
            fast = [rb for rb in ready
                    if not (rb == (0, 1) and model.pc[0][1][2] > 0)]
            return (fast or ready)[0]
        return pick

    q, tiles = _inputs(ndev, seed=3)
    model = RingModel(q, tiles, n_blocks=2, calls=2,
                      rng=np.random.default_rng(3), parity_counts=False)
    with pytest.raises(ScratchRace, match="rank 0 block 0 starts hop 2 "
                                          "while a block still folds hop 0"):
        model.run(pick_for(model))
    model = RingModel(q, tiles, n_blocks=2, calls=2,
                      rng=np.random.default_rng(3))
    _check(model, q, tiles, model.run(pick_for(model)))


@pytest.mark.fast
@pytest.mark.parametrize("ndev", [3, 4])
def test_without_the_freed_wait_a_sender_overruns(ndev):
    """The counterexample of the JAX kernel's ready_sem comment: without
    the freed wait, rank 0, one hop ahead of the starved rank 1, stores its
    next carry into rank 1's slot before rank 1 merged the one there."""
    q, tiles = _inputs(ndev, seed=7)
    model = RingModel(q, tiles, n_blocks=2, calls=2,
                      rng=np.random.default_rng(7), freed_wait=False)
    with pytest.raises(Overrun, match="rank 0 stores transfer 2 into rank "
                                      "1's slot 0, which still holds "
                                      "transfer 0"):
        model.run(_starving(slow=1))


@pytest.mark.fast
@pytest.mark.parametrize("case", ["one_rank", "peers", "same_card",
                                  "no_peer_access", "other_host"])
def test_ring_peer_problem(case):
    """K3's transfer stores into the neighbours' cards: a rank whose left
    or right neighbour is on another host, or on a card without peer
    access, is refused with the reason; ranks sharing a card need none."""
    where = [("h", f"cuda:{r}") for r in range(4)]
    no_access = set()
    want = [None] * 4
    if case == "one_rank":
        where, want = where[:1], [None]
    elif case == "same_card":
        where = [("h", "cuda:0")] * 4
        no_access = {("cuda:0", "cuda:0")}
    elif case == "no_peer_access":
        no_access = {("cuda:1", "cuda:2")}
        want[1] = ("rank 1's card cuda:1 has no peer access to its "
                   "neighbour rank 2's card cuda:2")
    elif case == "other_host":
        where[3] = ("g", "cuda:3")
        want[0] = "rank 0 (h) and its neighbour rank 3 (g) are on different " \
                  "hosts"
        want[2] = "rank 2 (h) and its neighbour rank 3 (g) are on different " \
                  "hosts"
        want[3] = "rank 3 (g) and its neighbour rank 0 (h) are on different " \
                  "hosts"
    assert [trb.ring_peer_problem(where, r,
                                  lambda a, b: (a, b) not in no_access)
            for r in range(len(where))] == want


# ---------------------------------------------------------------------- #
# the kernel on the card
# ---------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ring kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("concurrent", [False, True])
def test_kernel_transfer_matches_virtual_ring(cuda_device, ndev, concurrent):
    """The whole-ring kernel over virtual ranks on one card, hop by hop in
    ring order or every rank at once, three calls on the same regions:
    bit-equal to the per-hop ring."""
    rng = np.random.default_rng(ndev)
    q = torch.from_numpy(rng.standard_normal((200, 3)).astype(
        np.float32)).to(cuda_device)
    tiles = [torch.from_numpy(rng.standard_normal((70_000, 3)).astype(
        np.float32)).to(cuda_device) for _ in range(ndev)]
    want_v, want_i, R_pad = trb.ring_binfold_topk_virtual(q, tiles, 16)
    results, R2 = trb.ring_binfold_topk_transfer(q, tiles, 16,
                                                 concurrent=concurrent,
                                                 calls=3)
    assert R2 == R_pad and len(results) == 3
    for vals, idx in results:
        assert torch.equal(vals, want_v)
        assert torch.equal(torch.sort(idx, 1).values,
                           torch.sort(want_i, 1).values)
