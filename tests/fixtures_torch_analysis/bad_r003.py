"""R003 fixture: registry spec strings that do not resolve."""
from repro_torch.comm import codecs as CC
from repro_torch.core import attacks as ATK
from repro_torch.hier import GroupConfig


def bad_attack():
    return ATK.get_attack("definitely_not_an_attack")   # R003


def bad_codec_kwarg(make_step):
    return make_step(codec="qsgd:bits=nope")            # R003: bad param


def bad_hier():
    return GroupConfig.from_spec("g=7,bogus=1")         # R003: bad key


def fine(make_step):
    return make_step(codec=CC.get_codec("bf16"), attack="sign_flip")
