"""A word-level model of kernel K0 (``mpcium_tpu_torch/ops/csrc/mulmod.cu``)
in python ints, for the CPU tests: the kernel itself runs only on a card.

It follows the kernel step by step: a row on one warp of 32 lanes, lane
L holding words L·W .. L·W+W-1 of each operand; the CIOS iteration with
its two per-lane multiply-add chains, the q broadcast from lane 0 and the
one-word shift with the lane's carry left pending; the warp-parallel
carry and borrow by ballot and lookahead; the entry that streams all kw
words of a row; the three powmod modes and their exits. Shuffles and
ballots are list operations over the lanes, and every bound the kernel
relies on (a pending carry of at most 2, lane 0's bottom word cleared by
q·m, a value below 2m before the subtraction) is asserted as it runs.

``Model(consts)`` takes the port's own ``MulmodConsts``, so the host
constants are what the model is held to.
"""
from __future__ import annotations

MASK = 0xFFFFFFFF
LANES = 32
LIMB_BITS = 7
COMB_ROWS = 256


def ballot(bits) -> int:
    return sum(1 << lane for lane, b in enumerate(bits) if b)


def lookahead(g, p):
    """(carry into each lane, carry out of lane 31) from generate and
    propagate bits: the carries of (g|p) + g."""
    G, P = ballot(g), ballot(p)
    S = (G | P) + G
    mask = (S & MASK) ^ (G | P) ^ G
    return [(mask >> lane) & 1 for lane in range(LANES)], S >> 32


def words_of(v: int, count: int):
    return [(v >> (32 * i)) & MASK for i in range(count)]


def value_of(words) -> int:
    return sum(w << (32 * i) for i, w in enumerate(words))


class Model:
    def __init__(self, consts):
        self.c = consts
        self.W = consts.w
        self.S = 32 * consts.w
        self.kw = consts.kw
        self.k = consts.k
        self.n = consts.n
        self.m = consts.modulus
        self.mp = consts.mprime
        rows = [value_of([int(x) & MASK for x in r]) for r in consts.mont_words.tolist()]
        self.m_lanes = self.lanes(rows[0])
        self.c_mul, self.c_pow = rows[1], rows[2]
        self.R = 1 << (32 * self.S)

    # -- a row across the lanes ----------------------------------------------

    def lanes(self, v: int):
        w = words_of(v, self.S)
        return [w[L * self.W:(L + 1) * self.W] for L in range(LANES)]

    def value(self, lanes) -> int:
        return value_of([x for lane in lanes for x in lane])

    # -- the step --------------------------------------------------------------

    def iterate(self, ai: int, b, t, c) -> None:
        """One CIOS iteration over the warp, in place on the words t and
        the pending carries c."""
        W, m = self.W, self.m_lanes
        cy = [0] * LANES
        for L in range(LANES):
            for j in range(W):
                p = ai * b[L][j] + t[L][j] + cy[L]
                t[L][j], cy[L] = p & MASK, p >> 32
        q = (t[0][0] * self.mp) & MASK  # lane 0's, broadcast
        cq = [0] * LANES
        for L in range(LANES):
            for j in range(W):
                p = q * m[L][j] + t[L][j] + cq[L]
                t[L][j], cq[L] = p & MASK, p >> 32
        assert t[0][0] == 0
        up = [t[L + 1][0] if L < LANES - 1 else 0 for L in range(LANES)]  # shfl_down
        for L in range(LANES):
            s = c[L] + cy[L] + cq[L] + up[L]
            t[L] = t[L][1:] + [s & MASK]
            c[L] = s >> 32
            assert c[L] <= 2

    def finish(self, t, c):
        """Resolve the pending carries, subtract m once if reached."""
        W, m = self.W, self.m_lanes
        cin = [0] + c[:-1]  # shfl_up
        top = c[-1]
        g, p = [], []
        for L in range(LANES):
            s = cin[L]
            for j in range(W):
                s += t[L][j]
                t[L][j], s = s & MASK, s >> 32
            assert s <= 1
            g.append(s)
            p.append(all(x == MASK for x in t[L]))
        cin, cout = lookahead(g, p)
        top += cout
        for L in range(LANES):
            k = cin[L]
            for j in range(W):
                v = t[L][j] + k
                t[L][j], k = v & MASK, v >> 32
        assert top <= 1 and self.value(t) + (top << (32 * self.S)) < 2 * self.m
        d, g, p = [], [], []
        for L in range(LANES):
            br, row = 0, []
            for j in range(W):
                v = t[L][j] - m[L][j] - br
                row.append(v & MASK)
                br = 1 if v < 0 else 0
            d.append(row)
            g.append(br)
            p.append(all(x == 0 for x in row))
        bin_, bout = lookahead(g, p)
        if top or not bout:
            for L in range(LANES):
                br = bin_[L]
                for j in range(W):
                    v = d[L][j] - br
                    d[L][j], br = v & MASK, 1 if v < 0 else 0
            t = d
        return t

    def mont_mul(self, a, b):
        """a·b·R^-1 mod m: a broadcast word by word from its lanes."""
        t = [[0] * self.W for _ in range(LANES)]
        c = [0] * LANES
        for lane in range(LANES):
            for w in range(self.W):
                self.iterate(a[lane][w], b, t, c)
        return self.finish(t, c)

    def mont_stream(self, words, b):
        """a·b·2^(-32·len(words)) mod m: a staged row, every word."""
        t = [[0] * self.W for _ in range(LANES)]
        c = [0] * LANES
        for ai in words:
            self.iterate(ai, b, t, c)
        return self.finish(t, c)

    # -- limbs <-> words ---------------------------------------------------------

    def repack(self, limbs):
        out = []
        for w in range(self.kw):
            v, bit0 = 0, 32 * w
            l0, l1 = bit0 // LIMB_BITS, min((bit0 + 31) // LIMB_BITS, self.n - 1)
            for l in range(l0, l1 + 1):
                sh = LIMB_BITS * l - bit0
                v |= limbs[l] << sh if sh >= 0 else limbs[l] >> -sh
            out.append(v & MASK)
        return out

    def unpack(self, lanes):
        sh = [x for lane in lanes for x in lane]
        out = []
        for l in range(self.n):
            bit = LIMB_BITS * l
            w, s = bit >> 5, bit & 31
            v = (sh[w] if w < self.S else 0) | ((sh[w + 1] << 32) if w + 1 < self.S else 0)
            out.append((v >> s) & 127)
        return out

    def limbs(self, v: int):
        return [(v >> (LIMB_BITS * i)) & 127 for i in range(self.n)]

    @staticmethod
    def limbs_value(limbs) -> int:
        return sum(x << (LIMB_BITS * i) for i, x in enumerate(limbs))

    # -- the two kernels ------------------------------------------------------------

    def mulmod(self, a: int, b: int) -> int:
        """mulmod_kernel on two normalized n-limb rows."""
        p = self.mont_stream(self.repack(self.limbs(a)), self.lanes(self.c_mul))
        p = self.mont_stream(self.repack(self.limbs(b)), p)
        return self.limbs_value(self.unpack(p))

    def powmod(self, x, digits, mode: str, table=None, rpow=None) -> int:
        """powmod_kernel on one row: ``digits`` least significant first
        (4-bit, or 8-bit for "comb"); ``table[i][d]`` the canonical comb
        entries (python ints), ``rpow[j]`` = R^j mod m."""
        dmask = COMB_ROWS - 1 if mode == "comb" else 15
        nzi = [i for i, d in enumerate(digits) if d & dmask]
        acc = self.lanes(1)
        if not nzi:
            return self.limbs_value(self.unpack(acc))
        top, nz = nzi[-1], len(nzi)
        if mode == "comb":
            acc = self.lanes(table[nzi[0]][digits[nzi[0]] & dmask])
            for i in nzi[1:]:
                acc = self.mont_mul(acc, self.lanes(table[i][digits[i] & dmask]))
            if nz > 1:
                acc = self.mont_mul(acc, self.lanes(rpow[nz]))
        else:
            x1 = self.mont_stream(self.repack(self.limbs(x)), self.lanes(self.c_pow))
            tbl = [None, x1]
            acc = x1
            for _ in range(2, 16):
                acc = self.mont_mul(acc, x1)
                tbl.append(acc)
            acc = tbl[digits[top] & dmask]
            for i in range(top - 1, -1, -1):
                for _ in range(4):
                    acc = self.mont_mul(acc, acc)
                if digits[i] & dmask:
                    acc = self.mont_mul(acc, tbl[digits[i] & dmask])
            acc = self.mont_mul(acc, self.lanes(1))
        return self.limbs_value(self.unpack(acc))
