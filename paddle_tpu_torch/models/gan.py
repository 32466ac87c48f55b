"""DCGAN on MNIST-shaped images (book chapter 09 idiom).

Parity: the reference's fluid GAN recipe (tests/book high-level-api GAN /
09.gan book chapter): alternating D and G programs sharing parameter
scopes; a copy of ``paddle_tpu/models/gan.py`` on the port's layers.
build_gan() returns separate d_program / g_program whose generator and
discriminator parameters share names, so one Scope serves both and each
program's optimizer touches only its own tower's parameters
(parameter_list=).
"""


from ..core import framework
from .. import layers

NOISE_DIM = 100


def generator(z, ngf=64):
    """z (B, NOISE_DIM) -> img (B, 1, 28, 28), params prefixed g_."""
    from ..core.param_attr import ParamAttr

    def p(n):
        return ParamAttr(name=f"g_{n}")

    h = layers.fc(z, size=ngf * 2 * 7 * 7, param_attr=p("fc0_w"),
                  bias_attr=p("fc0_b"))
    h = layers.batch_norm(layers.reshape(h, shape=[-1, ngf * 2, 7, 7]),
                          act="relu", param_attr=p("bn0_s"),
                          bias_attr=p("bn0_b"))
    h = layers.conv2d_transpose(h, num_filters=ngf, filter_size=4, stride=2,
                                padding=1, param_attr=p("deconv1_w"),
                                bias_attr=p("deconv1_b"))
    h = layers.batch_norm(h, act="relu", param_attr=p("bn1_s"),
                          bias_attr=p("bn1_b"))
    img = layers.conv2d_transpose(h, num_filters=1, filter_size=4, stride=2,
                                  padding=1, act="tanh",
                                  param_attr=p("deconv2_w"),
                                  bias_attr=p("deconv2_b"))
    return img


def discriminator(img, ndf=64):
    """img (B,1,28,28) -> logit (B,1), params prefixed d_."""
    from ..core.param_attr import ParamAttr

    def p(n):
        return ParamAttr(name=f"d_{n}")

    h = layers.conv2d(img, num_filters=ndf, filter_size=4, stride=2,
                      padding=1, act="leaky_relu", param_attr=p("conv0_w"),
                      bias_attr=p("conv0_b"))
    h = layers.conv2d(h, num_filters=ndf * 2, filter_size=4, stride=2,
                      padding=1, param_attr=p("conv1_w"),
                      bias_attr=p("conv1_b"))
    h = layers.batch_norm(h, act="leaky_relu", param_attr=p("bn1_s"),
                          bias_attr=p("bn1_b"))
    return layers.fc(h, size=1, param_attr=p("fc_w"), bias_attr=p("fc_b"))


def build_gan(batch_size=32, noise_dim=NOISE_DIM):
    """Returns dict with d_program/g_program + their losses and feeds.

    d step: real imgs + fresh noise -> D loss (real vs fake).
    g step: fresh noise -> G loss (non-saturating).
    """
    d_program = framework.Program()
    g_program = framework.Program()

    with framework.program_guard(d_program):
        img = layers.data("img", shape=[1, 28, 28], dtype="float32")
        noise = layers.data("noise", shape=[noise_dim], dtype="float32")
        fake = generator(noise)
        d_real = discriminator(img)
        d_fake = discriminator(fake)
        ones = layers.fill_constant_batch_size_like(d_real, [-1, 1],
                                                    "float32", 1.0)
        zeros = layers.fill_constant_batch_size_like(d_fake, [-1, 1],
                                                     "float32", 0.0)
        d_loss = layers.mean(layers.elementwise_add(
            layers.sigmoid_cross_entropy_with_logits(x=d_real, label=ones),
            layers.sigmoid_cross_entropy_with_logits(x=d_fake, label=zeros)))

    with framework.program_guard(g_program):
        noise_g = layers.data("noise", shape=[noise_dim], dtype="float32")
        fake_g = generator(noise_g)
        d_on_fake = discriminator(fake_g)
        ones_g = layers.fill_constant_batch_size_like(d_on_fake, [-1, 1],
                                                      "float32", 1.0)
        g_loss = layers.mean(layers.sigmoid_cross_entropy_with_logits(
            x=d_on_fake, label=ones_g))

    d_params = [p.name for p in d_program.all_parameters()
                if p.name.startswith("d_")]
    g_params = [p.name for p in g_program.all_parameters()
                if p.name.startswith("g_")]
    return {"d_program": d_program, "g_program": g_program,
            "d_loss": d_loss, "g_loss": g_loss,
            "d_params": d_params, "g_params": g_params,
            "fake": fake_g}
