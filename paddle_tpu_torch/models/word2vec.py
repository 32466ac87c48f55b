"""word2vec N-gram language model (book chapter 04).

Parity: python/paddle/fluid/tests/book/test_word2vec.py: 4 context words,
one shared embedding table, concat -> hidden fc -> softmax over the
vocabulary; a copy of ``paddle_tpu/models/word2vec.py`` on the port's
layers.
"""


from .. import layers
from ..core.param_attr import ParamAttr

EMBED_SIZE = 32
HIDDEN_SIZE = 256
N_GRAM = 4


def build_trunk(dict_size, embed_size=EMBED_SIZE, hidden_size=HIDDEN_SIZE):
    """Returns (word_vars, next_word, hidden): the net up to its head.

    All four context words share one 'shared_w' embedding table, exactly the
    weight-tying scheme the book test uses (param_attr name sharing).
    """
    words = [layers.data(f"word_{i}", shape=[1], dtype="int64")
             for i in range(N_GRAM)]
    next_word = layers.data("next_word", shape=[1], dtype="int64")

    shared = ParamAttr(name="shared_w")
    embeds = [layers.embedding(w, size=[dict_size, embed_size],
                               param_attr=shared, is_sparse=False)
              for w in words]
    concat = layers.concat(input=embeds, axis=-1)
    concat = layers.reshape(concat, shape=[-1, N_GRAM * embed_size])
    hidden = layers.fc(concat, size=hidden_size, act="sigmoid")
    return words, next_word, hidden


def build_train_net(dict_size, embed_size=EMBED_SIZE,
                    hidden_size=HIDDEN_SIZE):
    """Returns (word_vars, next_word, prediction, avg_loss): build_trunk
    under a full softmax over the vocabulary."""
    words, next_word, hidden = build_trunk(dict_size, embed_size,
                                           hidden_size)
    prediction = layers.fc(hidden, size=dict_size, act="softmax")
    loss = layers.cross_entropy(input=prediction, label=next_word)
    avg_loss = layers.mean(loss)
    return words, next_word, prediction, avg_loss
