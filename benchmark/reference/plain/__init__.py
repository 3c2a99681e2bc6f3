"""A frozen copy of the port's plain PyTorch physics, envs and wrappers
(vnl_tpu_torch's physics/, math/, envs/, data/ and the plain halves of
ops/), as they stood when the benchmark was written.  Every hand-written
kernel is replaced by its plain version, nothing pins the matmul
precision (the judge sets it), and nothing here imports the port: the
benchmark's judge steps these envs from the states that the program's
timed path reached and compares what comes out."""
