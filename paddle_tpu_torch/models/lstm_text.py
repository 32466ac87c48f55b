"""Sentiment classification with stacked LSTM (book chapter 06, IMDB).

Parity: python/paddle/fluid/tests/book/notest_understand_sentiment.py
`stacked_lstm_net` — embedding -> fc+lstm stack with direction-alternating
layers -> max-pool over time -> softmax; a copy of
``paddle_tpu/models/lstm_text.py`` on the port's layers. Ragged text is
padded, with a lengths feed; ``size`` of each dynamic_lstm is 4 x its
hidden width (hid_dim 512 gives 128).
"""

from .. import layers

EMB_DIM = 128
HID_DIM = 128
STACKED_NUM = 3
MAX_LEN = 128


def stacked_lstm_net(data, seq_len, input_dim, class_dim=2, emb_dim=EMB_DIM,
                     hid_dim=HID_DIM, stacked_num=STACKED_NUM):
    emb = layers.embedding(data, size=[input_dim, emb_dim])

    fc1 = layers.fc(emb, size=hid_dim, num_flatten_dims=2)
    lstm1, _cell1 = layers.dynamic_lstm(fc1, size=hid_dim, length=seq_len)

    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        concat = layers.concat(inputs, axis=-1)
        fc = layers.fc(concat, size=hid_dim, num_flatten_dims=2)
        lstm, _cell = layers.dynamic_lstm(
            fc, size=hid_dim, length=seq_len, is_reverse=(i % 2 == 0))
        inputs = [fc, lstm]

    fc_last = layers.sequence_pool(inputs[0], pool_type="max", length=seq_len)
    lstm_last = layers.sequence_pool(inputs[1], pool_type="max",
                                     length=seq_len)
    return layers.fc([fc_last, lstm_last], size=class_dim, act="softmax")


def build_train_net(dict_dim, class_dim=2, max_len=MAX_LEN):
    """Returns (data, seq_len, label, prediction, avg_loss, acc)."""
    data = layers.data("words", shape=[max_len], dtype="int64")
    seq_len = layers.data("seq_len", shape=[1], dtype="int64")
    label = layers.data("label", shape=[1], dtype="int64")
    prediction = stacked_lstm_net(data, seq_len, input_dim=dict_dim,
                                  class_dim=class_dim)
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_loss = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    return data, seq_len, label, prediction, avg_loss, acc
