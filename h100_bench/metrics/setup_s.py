"""Seconds from the process's start to the start of the window."""


def read(obs):
    return obs.get("setup_s")
