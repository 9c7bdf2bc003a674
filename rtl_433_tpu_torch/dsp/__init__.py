from . import baseband

_ENGINE = ("DetectorParams", "detector_init", "process_block")


def __getattr__(name):
    # engine imports ops/, which imports baseband from here: load lazily
    if name in _ENGINE:
        from . import engine
        return getattr(engine, name)
    raise AttributeError(name)
