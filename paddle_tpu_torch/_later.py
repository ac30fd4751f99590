"""Stand-ins for reference names whose slice of the port is still to come:
calling one raises ``NotImplementedError`` naming its ROADMAP item (no
fallback)."""


def not_ported(name, item):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP {item})")

    refuse.__name__ = refuse.__qualname__ = name
    return refuse
