"""One file a command of the port's CLI that a traffic mix names
(``"command"``): ``argv(cfg, mix, inputs, paths, device)``, the arguments
of one call, and ``judge(truth, calls, sample, check_all_rows)``, the
numbers compared with the configuration's ``limits`` and notes on the
first wrong cells.  A scan-like command may add ``reference_table`` (the
control writes the reference's rows as the command would)."""
