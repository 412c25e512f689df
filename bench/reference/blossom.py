"""Exact maximum-weight matching on general graphs (Galil's O(n^3)
blossom algorithm after Van Rantwijk), a transliteration of networkx
3.6.1's `max_weight_matching` and `min_weight_matching`.

A frozen copy kept with the benchmark's plain reference, which builds
the paper's overlay again without importing the program. The
Christofides overlay (`overlay.christofides_cycle`) matches
the odd-degree nodes of a spanning tree, and a different matching of
equal weight gives a different tour, so this module follows networkx
step by step, ties included: the same node and neighbour orders, the
same labels, queue, least-slack edges and delta choices, and the same
float arithmetic. A graph is a dict of dicts, ``adj[v][w] = weight``,
whose key orders stand for networkx's node and neighbour orders
(``list(G)`` and ``G.neighbors(v)``); an edge appears in both
endpoints' dicts with one weight. Self-loops are not supported.

Adapted from NetworkX (networkx/algorithms/matching.py), which carries
this notice:

    Copyright (c) 2004-2025, NetworkX Developers
    Aric Hagberg <hagberg@lanl.gov>
    Dan Schult <dschult@colgate.edu>
    Pieter Swart <swart@lanl.gov>
    All rights reserved.

    Redistribution and use in source and binary forms, with or without
    modification, are permitted provided that the following conditions
    are met:

      * Redistributions of source code must retain the above copyright
        notice, this list of conditions and the following disclaimer.

      * Redistributions in binary form must reproduce the above
        copyright notice, this list of conditions and the following
        disclaimer in the documentation and/or other materials provided
        with the distribution.

      * Neither the name of the NetworkX Developers nor the names of its
        contributors may be used to endorse or promote products derived
        from this software without specific prior written permission.

    THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS
    "AS IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT
    LIMITED TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS
    FOR A PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE
    COPYRIGHT OWNER OR CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT,
    INCIDENTAL, SPECIAL, EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING,
    BUT NOT LIMITED TO, PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES;
    LOSS OF USE, DATA, OR PROFITS; OR BUSINESS INTERRUPTION) HOWEVER
    CAUSED AND ON ANY THEORY OF LIABILITY, WHETHER IN CONTRACT, STRICT
    LIABILITY, OR TORT (INCLUDING NEGLIGENCE OR OTHERWISE) ARISING IN
    ANY WAY OUT OF THE USE OF THIS SOFTWARE, EVEN IF ADVISED OF THE
    POSSIBILITY OF SUCH DAMAGE.
"""

from __future__ import annotations

from itertools import repeat

Adjacency = dict  # node -> {neighbour: weight}, in networkx's orders


def _edges(adj: Adjacency):
    """networkx's `G.edges(data=weight)` order: node order, then
    neighbour order, each edge once from its earlier-visited end."""
    seen = set()
    for u, nbrs in adj.items():
        for v, wt in nbrs.items():
            if v not in seen:
                yield u, v, wt
        seen.add(u)


def _to_pairs(mate: dict) -> list[tuple]:
    """networkx's `matching_dict_to_set`, as a list in its insertion
    order: each matched pair once, oriented as first met in ``mate``."""
    edges: list[tuple] = []
    seen = set()
    for u, v in mate.items():
        if (v, u) in seen or (u, v) in seen:
            continue
        seen.add((u, v))
        edges.append((u, v))
    return edges


def min_weight_matching(adj: Adjacency) -> list[tuple]:
    """Minimum-weight maximum-cardinality matching: `max_weight_matching`
    with ``maxcardinality=True`` on the weights ``(1 + max w) - w``,
    computed in the weights' own type (float64 for floats, so a rounding
    there can make or break a tie exactly as in networkx), over a graph
    rebuilt from the edge list as networkx rebuilds it."""
    edges = list(_edges(adj))
    if not edges:
        return max_weight_matching(adj, maxcardinality=True)
    max_weight = 1 + max(w for _, _, w in edges)
    inv: Adjacency = {}
    for u, v, w in edges:
        inv.setdefault(u, {})
        inv.setdefault(v, {})
        inv[u][v] = inv[v][u] = max_weight - w
    return max_weight_matching(inv, maxcardinality=True)


class _NoNode:
    """Dummy value which is different from any node."""


class _Blossom:
    """A non-trivial blossom or sub-blossom.

    ``childs`` is the ordered list of sub-blossoms, starting with the
    base and going round the blossom; ``edges[i] = (v, w)`` connects a
    vertex v of ``childs[i]`` to a vertex w of ``childs[i+1]`` (wrapping);
    ``mybestedges`` (top-level S-blossoms) lists least-slack edges to
    neighbouring S-blossoms, or None if not computed yet."""

    __slots__ = ["childs", "edges", "mybestedges"]

    def leaves(self):
        stack = [*self.childs]
        while stack:
            t = stack.pop()
            if isinstance(t, _Blossom):
                stack.extend(t.childs)
            else:
                yield t


def max_weight_matching(adj: Adjacency,
                        maxcardinality: bool = False) -> list[tuple]:
    """Maximum-weight matching of ``adj`` (with ``maxcardinality``, the
    heaviest among the maximum-cardinality matchings), as networkx's
    `max_weight_matching` returns it. Integer weights (Python ``int``)
    keep the arithmetic integral and are verified optimal at the end."""
    # Names and terms follow Galil, "Efficient Algorithms for Finding
    # Maximum Matching in Graphs", ACM Computing Surveys, 1986.
    Blossom = _Blossom
    NoNode = _NoNode
    gnodes = list(adj)
    if not gnodes:
        return []

    maxweight = 0
    allinteger = True
    for i, j, wt in _edges(adj):
        if i != j and wt > maxweight:
            maxweight = wt
        allinteger = allinteger and type(wt) is int

    # mate[v]: v's partner; single vertices are absent.
    mate: dict = {}
    # label[b] of a top-level blossom: None free, 1 S, 2 T (5 marks a
    # breadcrumb in scanBlossom); label[v] == 2 for a vertex inside a
    # T-blossom reachable from an S-vertex outside it.
    label: dict = {}
    # labeledge[b] = (v, w): the edge through which b got its label (w in
    # b), None if b's base is single.
    labeledge: dict = {}
    inblossom = dict(zip(gnodes, gnodes))
    blossomparent = dict(zip(gnodes, repeat(None)))
    blossombase = dict(zip(gnodes, gnodes))
    # bestedge[w]: least-slack edge from an S-vertex to free w;
    # bestedge[b]: least-slack edge from S-blossom b to another S-blossom.
    bestedge: dict = {}
    # dualvar[v] = 2 u(v); starts at maxweight.
    dualvar = dict(zip(gnodes, repeat(maxweight)))
    # blossomdual[b] = z(b) of a non-trivial blossom.
    blossomdual: dict = {}
    # (v, w) in allowedge: the edge is known to have zero slack.
    allowedge: dict = {}
    queue: list = []

    def slack(v, w):
        """2 * slack of edge (v, w) (not inside blossoms)."""
        return dualvar[v] + dualvar[w] - 2 * adj[v][w]

    def assignLabel(w, t, v):
        """Label the top-level blossom of w with t, reached from v."""
        b = inblossom[w]
        label[w] = label[b] = t
        if v is not None:
            labeledge[w] = labeledge[b] = (v, w)
        else:
            labeledge[w] = labeledge[b] = None
        bestedge[w] = bestedge[b] = None
        if t == 1:
            if isinstance(b, Blossom):
                queue.extend(b.leaves())
            else:
                queue.append(b)
        elif t == 2:
            base = blossombase[b]
            assignLabel(mate[base], 1, base)

    def scanBlossom(v, w):
        """Trace back from v and w: the base vertex of a new blossom, or
        NoNode if an augmenting path was found."""
        path = []
        base = NoNode
        while v is not NoNode:
            b = inblossom[v]
            if label[b] & 4:
                base = blossombase[b]
                break
            path.append(b)
            label[b] = 5
            if labeledge[b] is None:
                v = NoNode
            else:
                v = labeledge[b][0]
                b = inblossom[v]
                v = labeledge[b][0]
            if w is not NoNode:
                v, w = w, v
        for b in path:
            label[b] = 1
        return base

    def addBlossom(base, v, w):
        """New S-blossom with the given base, through S-vertices v, w."""
        bb = inblossom[base]
        bv = inblossom[v]
        bw = inblossom[w]
        b = Blossom()
        blossombase[b] = base
        blossomparent[b] = None
        blossomparent[bb] = b
        b.childs = path = []
        b.edges = edgs = [(v, w)]
        while bv != bb:
            blossomparent[bv] = b
            path.append(bv)
            edgs.append(labeledge[bv])
            v = labeledge[bv][0]
            bv = inblossom[v]
        path.append(bb)
        path.reverse()
        edgs.reverse()
        while bw != bb:
            blossomparent[bw] = b
            path.append(bw)
            edgs.append((labeledge[bw][1], labeledge[bw][0]))
            w = labeledge[bw][0]
            bw = inblossom[w]
        label[b] = 1
        labeledge[b] = labeledge[bb]
        blossomdual[b] = 0
        for v in b.leaves():
            if label[inblossom[v]] == 2:
                queue.append(v)
            inblossom[v] = b
        bestedgeto = {}
        for bv in path:
            if isinstance(bv, Blossom):
                if bv.mybestedges is not None:
                    nblist = bv.mybestedges
                    bv.mybestedges = None
                else:
                    nblist = [(v, w) for v in bv.leaves()
                              for w in adj[v] if v != w]
            else:
                nblist = [(bv, w) for w in adj[bv] if bv != w]
            for k in nblist:
                (i, j) = k
                if inblossom[j] == b:
                    i, j = j, i
                bj = inblossom[j]
                if (bj != b and label.get(bj) == 1
                        and ((bj not in bestedgeto)
                             or slack(i, j) < slack(*bestedgeto[bj]))):
                    bestedgeto[bj] = k
            bestedge[bv] = None
        b.mybestedges = list(bestedgeto.values())
        mybestedge = None
        bestedge[b] = None
        for k in b.mybestedges:
            kslack = slack(*k)
            if mybestedge is None or kslack < mybestslack:
                mybestedge = k
                mybestslack = kslack
        bestedge[b] = mybestedge

    def expandBlossom(b, endstage):
        """Expand a top-level blossom (recursion as a trampoline)."""

        def _recurse(b, endstage):
            for s in b.childs:
                blossomparent[s] = None
                if isinstance(s, Blossom):
                    if endstage and blossomdual[s] == 0:
                        yield s
                    else:
                        for v in s.leaves():
                            inblossom[v] = s
                else:
                    inblossom[s] = s
            if (not endstage) and label.get(b) == 2:
                # Relabel the sub-blossoms from the one through which b
                # got its label round to the base.
                entrychild = inblossom[labeledge[b][1]]
                j = b.childs.index(entrychild)
                if j & 1:
                    j -= len(b.childs)
                    jstep = 1
                else:
                    jstep = -1
                v, w = labeledge[b]
                while j != 0:
                    if jstep == 1:
                        p, q = b.edges[j]
                    else:
                        q, p = b.edges[j - 1]
                    label[w] = None
                    label[q] = None
                    assignLabel(w, 2, v)
                    allowedge[(p, q)] = allowedge[(q, p)] = True
                    j += jstep
                    if jstep == 1:
                        v, w = b.edges[j]
                    else:
                        w, v = b.edges[j - 1]
                    allowedge[(v, w)] = allowedge[(w, v)] = True
                    j += jstep
                bw = b.childs[j]
                label[w] = label[bw] = 2
                labeledge[w] = labeledge[bw] = (v, w)
                bestedge[bw] = None
                j += jstep
                while b.childs[j] != entrychild:
                    bv = b.childs[j]
                    if label.get(bv) == 1:
                        j += jstep
                        continue
                    if isinstance(bv, Blossom):
                        for v in bv.leaves():
                            if label.get(v):
                                break
                    else:
                        v = bv
                    if label.get(v):
                        label[v] = None
                        label[mate[blossombase[bv]]] = None
                        assignLabel(v, 2, labeledge[v][0])
                    j += jstep
            label.pop(b, None)
            labeledge.pop(b, None)
            bestedge.pop(b, None)
            del blossomparent[b]
            del blossombase[b]
            del blossomdual[b]

        stack = [_recurse(b, endstage)]
        while stack:
            top = stack[-1]
            for s in top:
                stack.append(_recurse(s, endstage))
                break
            else:
                stack.pop()

    def augmentBlossom(b, v):
        """Swap matched and unmatched edges on the alternating path
        through blossom b from vertex v to the base (a trampoline)."""

        def _recurse(b, v):
            t = v
            while blossomparent[t] != b:
                t = blossomparent[t]
            if isinstance(t, Blossom):
                yield (t, v)
            i = j = b.childs.index(t)
            if i & 1:
                j -= len(b.childs)
                jstep = 1
            else:
                jstep = -1
            while j != 0:
                j += jstep
                t = b.childs[j]
                if jstep == 1:
                    w, x = b.edges[j]
                else:
                    x, w = b.edges[j - 1]
                if isinstance(t, Blossom):
                    yield (t, w)
                j += jstep
                t = b.childs[j]
                if isinstance(t, Blossom):
                    yield (t, x)
                mate[w] = x
                mate[x] = w
            b.childs = b.childs[i:] + b.childs[:i]
            b.edges = b.edges[i:] + b.edges[:i]
            blossombase[b] = blossombase[b.childs[0]]

        stack = [_recurse(b, v)]
        while stack:
            top = stack[-1]
            for args in top:
                stack.append(_recurse(*args))
                break
            else:
                stack.pop()

    def augmentMatching(v, w):
        """Augment along the path through S-vertices v and w."""
        for s, j in ((v, w), (w, v)):
            while 1:
                bs = inblossom[s]
                if isinstance(bs, Blossom):
                    augmentBlossom(bs, s)
                mate[s] = j
                if labeledge[bs] is None:
                    break
                t = labeledge[bs][0]
                bt = inblossom[t]
                s, j = labeledge[bt]
                if isinstance(bt, Blossom):
                    augmentBlossom(bt, j)
                mate[j] = s

    def verifyOptimum():
        """Complementary slackness of the final duals (integer weights)."""
        vdualoffset = (max(0, -min(dualvar.values())) if maxcardinality
                       else 0)
        ok = min(dualvar.values()) + vdualoffset >= 0
        ok &= len(blossomdual) == 0 or min(blossomdual.values()) >= 0
        for i, j, wt in _edges(adj):
            if i == j:
                continue
            s = dualvar[i] + dualvar[j] - 2 * wt
            iblossoms = [i]
            jblossoms = [j]
            while blossomparent[iblossoms[-1]] is not None:
                iblossoms.append(blossomparent[iblossoms[-1]])
            while blossomparent[jblossoms[-1]] is not None:
                jblossoms.append(blossomparent[jblossoms[-1]])
            iblossoms.reverse()
            jblossoms.reverse()
            for bi, bj in zip(iblossoms, jblossoms):
                if bi != bj:
                    break
                s += 2 * blossomdual[bi]
            ok &= s >= 0
            if mate.get(i) == j or mate.get(j) == i:
                ok &= mate[i] == j and mate[j] == i and s == 0
        for v in gnodes:
            ok &= (v in mate) or dualvar[v] + vdualoffset == 0
        for b in blossomdual:
            if blossomdual[b] > 0:
                ok &= len(b.edges) % 2 == 1
                for i, j in b.edges[1::2]:
                    ok &= mate[i] == j and mate[j] == i
        if not ok:
            raise RuntimeError("max_weight_matching: the matching is not "
                               "optimal")

    while 1:
        # A stage: find an augmenting path and improve the matching.
        label.clear()
        labeledge.clear()
        bestedge.clear()
        for b in blossomdual:
            b.mybestedges = None
        allowedge.clear()
        queue[:] = []
        for v in gnodes:
            if (v not in mate) and label.get(inblossom[v]) is None:
                assignLabel(v, 1, None)

        augmented = 0
        while 1:
            # A substage: label until an augmenting path is found, else
            # move the duals by delta.
            while queue and not augmented:
                v = queue.pop()
                for w in adj[v]:
                    if w == v:
                        continue
                    bv = inblossom[v]
                    bw = inblossom[w]
                    if bv == bw:
                        continue
                    if (v, w) not in allowedge:
                        kslack = slack(v, w)
                        if kslack <= 0:
                            allowedge[(v, w)] = allowedge[(w, v)] = True
                    if (v, w) in allowedge:
                        if label.get(bw) is None:
                            assignLabel(w, 2, v)
                        elif label.get(bw) == 1:
                            base = scanBlossom(v, w)
                            if base is not NoNode:
                                addBlossom(base, v, w)
                            else:
                                augmentMatching(v, w)
                                augmented = 1
                                break
                        elif label.get(w) is None:
                            label[w] = 2
                            labeledge[w] = (v, w)
                    elif label.get(bw) == 1:
                        if (bestedge.get(bv) is None
                                or kslack < slack(*bestedge[bv])):
                            bestedge[bv] = (v, w)
                    elif label.get(w) is None:
                        if (bestedge.get(w) is None
                                or kslack < slack(*bestedge[w])):
                            bestedge[w] = (v, w)

            if augmented:
                break

            # No augmenting path: the least delta of the four kinds
            # (duals and slacks are premultiplied by two).
            deltatype = -1
            delta = deltaedge = deltablossom = None
            if not maxcardinality:
                deltatype = 1
                delta = min(dualvar.values())
            for v in gnodes:
                if (label.get(inblossom[v]) is None
                        and bestedge.get(v) is not None):
                    d = slack(*bestedge[v])
                    if deltatype == -1 or d < delta:
                        delta = d
                        deltatype = 2
                        deltaedge = bestedge[v]
            for b in blossomparent:
                if (blossomparent[b] is None and label.get(b) == 1
                        and bestedge.get(b) is not None):
                    kslack = slack(*bestedge[b])
                    if allinteger:
                        d = kslack // 2
                    else:
                        d = kslack / 2.0
                    if deltatype == -1 or d < delta:
                        delta = d
                        deltatype = 3
                        deltaedge = bestedge[b]
            for b in blossomdual:
                if (blossomparent[b] is None and label.get(b) == 2
                        and (deltatype == -1 or blossomdual[b] < delta)):
                    delta = blossomdual[b]
                    deltatype = 4
                    deltablossom = b
            if deltatype == -1:
                # Max-cardinality optimum; a final delta makes it
                # verifiable.
                deltatype = 1
                delta = max(0, min(dualvar.values()))

            for v in gnodes:
                if label.get(inblossom[v]) == 1:
                    dualvar[v] -= delta
                elif label.get(inblossom[v]) == 2:
                    dualvar[v] += delta
            for b in blossomdual:
                if blossomparent[b] is None:
                    if label.get(b) == 1:
                        blossomdual[b] += delta
                    elif label.get(b) == 2:
                        blossomdual[b] -= delta

            if deltatype == 1:
                break
            elif deltatype == 2:
                (v, w) = deltaedge
                allowedge[(v, w)] = allowedge[(w, v)] = True
                queue.append(v)
            elif deltatype == 3:
                (v, w) = deltaedge
                allowedge[(v, w)] = allowedge[(w, v)] = True
                queue.append(v)
            elif deltatype == 4:
                expandBlossom(deltablossom, False)

        if not augmented:
            break

        # End of a stage: expand every S-blossom with zero dual.
        for b in list(blossomdual.keys()):
            if b not in blossomdual:
                continue
            if (blossomparent[b] is None and label.get(b) == 1
                    and blossomdual[b] == 0):
                expandBlossom(b, True)

    if allinteger:
        verifyOptimum()
    return _to_pairs(mate)
