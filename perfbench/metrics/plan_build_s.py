"""The harness's wall around ``build_routed_operator`` in set-up (host)."""


def read(run):
    return run["info"].get("plan_build_s")
