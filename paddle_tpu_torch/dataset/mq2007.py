"""MQ2007 learning-to-rank dataset (LETOR 4.0).

Parity: python/paddle/dataset/mq2007.py (Query:50, QueryList:106,
pointwise/pairwise/listwise generators:169-249). Decodes the real LETOR
text format ("rel qid:N 1:v 2:v ... #docid ...") when the files exist
under DATA_HOME (mq2007/Fold1/{train,vali,test}.txt); deterministic
synthetic queries with the standard 46 features otherwise (zero-egress).
"""

import numpy as np

from .common import data_file, _rng

FEATURE_DIM = 46


class Query:
    """One judged document: relevance score, query id, feature vector."""

    def __init__(self, query_id=-1, relevance_score=-1, feature_vector=None,
                 description=""):
        self.query_id = query_id
        self.relevance_score = relevance_score
        # no `or []`: truthiness on a numpy feature array raises
        self.feature_vector = [] if feature_vector is None else feature_vector
        self.description = description

    def __str__(self):
        feats = " ".join(f"{i + 1}:{v}"
                         for i, v in enumerate(self.feature_vector))
        return f"{self.relevance_score} qid:{self.query_id} {feats}"

    @classmethod
    def parse(cls, line, fill_missing=-1):
        """Parse one LETOR line; missing feature ids fill with
        `fill_missing` (the reference's contract for sparse rows)."""
        body, _, desc = line.partition("#")
        parts = body.split()
        rel = int(parts[0])
        qid = int(parts[1].split(":")[1])
        pairs = [p.split(":") for p in parts[2:] if ":" in p]
        idx_val = {int(i): float(v) for i, v in pairs}
        # fixed 46-dim LETOR vector (longer ids extend it): trailing
        # missing features must fill too, or vectors come out ragged
        dim = max(FEATURE_DIM, max(idx_val) if idx_val else 0)
        vec = [idx_val.get(i + 1, fill_missing) for i in range(dim)]
        return cls(qid, rel, vec, desc.strip())


class QueryList:
    """All judged documents sharing one query id."""

    def __init__(self, querylist=None):
        self.querylist = querylist or []
        self.query_id = self.querylist[0].query_id if self.querylist else -1

    def __iter__(self):
        return iter(self.querylist)

    def __len__(self):
        return len(self.querylist)

    def __getitem__(self, i):
        return self.querylist[i]

    def add_query(self, q):
        if self.query_id == -1:
            self.query_id = q.query_id
        elif q.query_id != self.query_id:
            raise ValueError("query id mismatch in QueryList")
        self.querylist.append(q)


def load_from_text(filepath, shuffle=False, fill_missing=-1):
    """Group a LETOR file into QueryLists (insertion order, optional
    shuffle of the query order like the reference)."""
    lists, by_id = [], {}
    with open(filepath) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            q = Query.parse(line, fill_missing)
            if q.query_id not in by_id:
                by_id[q.query_id] = QueryList()
                lists.append(by_id[q.query_id])
            by_id[q.query_id].add_query(q)
    if shuffle:
        np.random.shuffle(lists)
    return lists


def _synthetic_querylists(n_queries, seed, docs_per_query=8):
    """Learnable synthetic LETOR: relevance = bucketed linear score of the
    features, so ranking models beat random on it."""
    rng = _rng(seed)
    w = _rng(2007).randn(FEATURE_DIM)
    lists = []
    for qid in range(1, n_queries + 1):
        ql = QueryList()
        for _ in range(docs_per_query):
            x = rng.rand(FEATURE_DIM)
            score = float(x @ w)
            rel = int(np.clip((score - w.sum() * 0.5) * 2 + 1, 0, 2))
            ql.add_query(Query(qid, rel, x.tolist()))
        lists.append(ql)
    return lists


def _querylists(split, seed):
    path = data_file(f"mq2007/Fold1/{split}.txt", f"MQ2007/Fold1/{split}.txt")
    if path:
        return load_from_text(path)
    return _synthetic_querylists(60 if split == "train" else 20, seed)


def gen_plain_txt(querylist):
    """-> (query_id, relevance, features) per document."""
    for q in querylist:
        yield q.query_id, q.relevance_score, np.array(q.feature_vector)


def gen_point(querylist):
    """Pointwise: -> (relevance, features) per document."""
    for q in querylist:
        yield q.relevance_score, np.array(q.feature_vector)


def gen_pair(querylist, partial_order="full"):
    """Pairwise: -> (1, higher_features, lower_features) for every pair
    with different relevance (the reference's full partial order).
    Only the 'full' order is implemented; the reference's 'neighbour'
    variant raises instead of silently returning full-order pairs."""
    if partial_order != "full":
        raise NotImplementedError(
            f"mq2007.gen_pair partial_order={partial_order!r}: only "
            f"'full' is implemented (reference also offers 'neighbour')")
    docs = sorted(querylist, key=lambda q: -q.relevance_score)
    for i, hi in enumerate(docs):
        for lo in docs[i + 1:]:
            if hi.relevance_score > lo.relevance_score:
                yield (np.array([1.0]), np.array(hi.feature_vector),
                       np.array(lo.feature_vector))


def gen_list(querylist):
    """Listwise: -> (relevance_list, feature_matrix) per query."""
    rels = [q.relevance_score for q in querylist]
    feats = np.array([q.feature_vector for q in querylist])
    yield rels, feats


_GEN = {"plain_txt": gen_plain_txt, "pointwise": gen_point,
        "pairwise": gen_pair, "listwise": gen_list}


def _reader(split, fmt, seed):
    if fmt not in _GEN:
        raise ValueError(f"format must be one of {sorted(_GEN)}; got {fmt}")

    def reader():
        for ql in _querylists(split, seed):
            yield from _GEN[fmt](ql)

    return reader


def train(format="pairwise"):
    return _reader("train", format, seed=71)


def test(format="pairwise"):
    return _reader("test", format, seed=72)


def fetch():
    """No egress in this environment: point the user at DATA_HOME."""
    from .common import DATA_HOME
    raise RuntimeError(
        f"mq2007 cannot be downloaded here; place LETOR 4.0 files under "
        f"{DATA_HOME}/mq2007/Fold1/ to use the real data")
