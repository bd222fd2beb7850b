"""Faults planted under the timed path, for the tests and for the readings
the limits are set from (``control.py --faults``): each replaces a part of
a session (``program.Train`` or ``program.Transcribe``)."""


def unchanged_state(session):
    """The train step computes its gradients and returns its state
    unchanged."""
    step = session.step_fn

    def broken(state, batch):
        _, grad_norm, metrics = step.gradients(state, batch)
        return type(state)(state.params, state.opt_state, state.step + 1), \
            {**metrics, "grad_norm": grad_norm}
    session.step_fn = broken


def half_batch(session):
    """The train step leaves out half of the batch and takes the mean over
    the rest."""
    step = session.step_fn

    def broken(state, batch):
        n = batch["input_values"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()})
    session.step_fn = broken


def altered_token(session):
    """generate's second token of every row replaced by the next id."""
    generate = session._generate
    vocab = session.cfg["decoder"]["vocab_size"]

    def broken(batch):
        tokens, scores = generate(batch)
        tokens = tokens.clone()
        tokens[:, 1] = (tokens[:, 1] + 1) % vocab
        return tokens, scores
    session._generate = broken


def altered_last_token(session):
    """generate's last token of every row replaced by the next id, its
    scores left as they were: no later position reads it."""
    generate = session._generate
    vocab = session.cfg["decoder"]["vocab_size"]

    def broken(batch):
        tokens, scores = generate(batch)
        tokens = tokens.clone()
        tokens[:, -1] = (tokens[:, -1] + 1) % vocab
        return tokens, scores
    session._generate = broken


TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch}
TRANSCRIBE = {"altered_token": altered_token,
              "altered_last_token": altered_last_token}
