"""Host milliseconds of the encoder's call on the traced batch, ended by a synchronize."""


def read(rec):
    return rec["encoder_s"] * 1e3 if "encoder_s" in rec else None
