"""Device ms of the teacher's document forward alone (make_apply_fn(teacher) on a batch's [B x (1 +
negatives), L] documents)."""

from h100_bench import readers


def read(obs):
    return readers.span_ms(obs, "teacher_docs")
