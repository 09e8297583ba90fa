"""Dry run (``repro.launch.dryrun``'s counterpart): not ported.  Its
compiled-program and roofline accounting belongs to the analysis item,
ROADMAP "Queue 1: analysis + benchmarks"."""


def main(argv=None):
    raise NotImplementedError("the dry run is not ported: ROADMAP Queue 1: "
                              "analysis + benchmarks")


if __name__ == "__main__":
    main()
