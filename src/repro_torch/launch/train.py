"""Training launcher, ``repro.launch.train``'s counterpart: not ported.
Training (``ce_loss``, ``loss_fn``, ``train_step`` with the flash
backward, ``train/``) is ROADMAP Queue 1 item 10."""


def main(argv=None):
    raise NotImplementedError("training is not ported: ROADMAP Queue 1 "
                              "item 10 (training)")


if __name__ == "__main__":
    main()
