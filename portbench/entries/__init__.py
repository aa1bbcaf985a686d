"""The program's entry points, one file each, named by a traffic mix's
`"entry"`.

Each module `<entry>.py` has:

  setup(inputs, cl, device) -> prog     the program's state built from
                                        the scene, in set-up;
  solve(prog) -> (outputs, iterations)  one whole unit of the mix's work
                                        from the same start, closed by a
                                        synchronize; `outputs` holds what
                                        the check compares;
  reference(inputs, cl, dtype=torch.float64, tf32=False) -> ref
                                        the plain reference's answer to
                                        the same scene (float32 with
                                        `tf32`: the control);
  outputs_of(ref) -> outputs            a reference's answer in the
                                        layout of `solve`'s outputs;
  numbers(outputs, ref) -> {name: number}
                                        what `limits/<workload>.json`
                                        bounds.

The window drives `solve` in a closed loop.
"""
