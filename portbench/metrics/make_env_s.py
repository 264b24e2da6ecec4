"""Host seconds of the program's ``make_env`` and its first reset, inside
set-up."""


def read(r):
    return r.get("make_env_s")
