"""index_build_s (index build; moves setup_s): host seconds from a
synchronize before the index's constructor to a synchronize after its
`add` of the base rows and the mix's `prepare` steps (a serving pack), in
the run's set-up, which is never traced."""


def read(run):
    return run.build_s
