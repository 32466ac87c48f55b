"""MovieLens (synthetic). Parity: python/paddle/dataset/movielens.py."""
import numpy as np
from .common import _rng

MAX_USER_ID = 6040
MAX_MOVIE_ID = 3952
AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]
MAX_JOB_ID = 20
CATEGORIES = 18
TITLE_DICT_SIZE = 5174


def max_user_id():
    return MAX_USER_ID


def max_movie_id():
    return MAX_MOVIE_ID


def max_job_id():
    return MAX_JOB_ID


def age_table():
    return AGE_TABLE


def movie_categories():
    return {f"cat{i}": i for i in range(CATEGORIES)}


def get_movie_title_dict():
    return {f"t{i}": i for i in range(TITLE_DICT_SIZE)}


def _reader(num, seed):
    def r():
        rng = _rng(seed)
        for _ in range(num):
            uid = int(rng.randint(1, MAX_USER_ID + 1))
            gender = int(rng.randint(2))
            age = int(rng.randint(len(AGE_TABLE)))
            job = int(rng.randint(MAX_JOB_ID + 1))
            mid = int(rng.randint(1, MAX_MOVIE_ID + 1))
            cat = [int(rng.randint(CATEGORIES))]
            title = rng.randint(0, TITLE_DICT_SIZE, size=5).astype("int64")
            # rating correlated with (uid+mid) parity for learnability
            score = float(((uid + mid + age) % 5) + 1)
            yield (np.int64(uid), np.int64(gender), np.int64(age),
                   np.int64(job), np.int64(mid),
                   np.asarray(cat, "int64"), title,
                   np.array([score], "float32"))
    return r


def train():
    return _reader(8192, seed=92)


def test():
    return _reader(1024, seed=93)


class MovieInfo:
    """Parity: dataset/movielens.py MovieInfo record."""

    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index,
                [CATEGORIES_DICT[c] for c in self.categories],
                [TITLE_DICT[w.lower()] for w in self.title.split()]]

    def __repr__(self):
        return (f"<MovieInfo id({self.index}), "
                f"title({self.title}), categories({self.categories})>")


class UserInfo:
    """Parity: dataset/movielens.py UserInfo record."""

    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = AGE_TABLE.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]

    def __repr__(self):
        return (f"<UserInfo id({self.index}), gender({'M' if self.is_male else 'F'}), "
                f"age({AGE_TABLE[self.age]}), job({self.job_id})>")


CATEGORIES_DICT = movie_categories()
TITLE_DICT = get_movie_title_dict()


def _meta(seed=95):
    rng = _rng(seed)
    movies = {}
    for mid in range(1, MAX_MOVIE_ID + 1):
        cats = [f"cat{int(rng.randint(CATEGORIES))}"]
        title = " ".join(f"t{int(t)}" for t in
                         rng.randint(0, TITLE_DICT_SIZE, size=3))
        movies[mid] = MovieInfo(mid, cats, title)
    users = {}
    for uid in range(1, MAX_USER_ID + 1):
        users[uid] = UserInfo(uid, "M" if rng.randint(2) else "F",
                              AGE_TABLE[int(rng.randint(len(AGE_TABLE)))],
                              int(rng.randint(MAX_JOB_ID + 1)))
    return movies, users


_META = None


def _init_meta():
    global _META
    if _META is None:
        _META = _meta()
    return _META


def movie_info():
    """Parity: dataset/movielens.py:240 — {movie_id: MovieInfo}
    (deterministic synthetic metadata matching the id/vocab ranges)."""
    return _init_meta()[0]


def user_info():
    """Parity: dataset/movielens.py:232 — {user_id: UserInfo}."""
    return _init_meta()[1]
