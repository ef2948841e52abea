"""The hand kernels' families, one file each: ``<family>.py`` for each of
the program's ``csrc/<family>.cu``, found by ``roofline.families()`` by
glob.  A family file holds:

  ENTRIES       its entry points: the names through which the autograd
                Functions of ``supervised_gan_tpu_torch.ops.kernels
                .functions`` call its kernel wrappers, each recorded with
                its cost (``roofline.recording``);
  DEVICE_NAMES  the identifiers of its device operations, as they appear in
                a traced kernel's demangled name;
  cost(entry, args)  (flops, bytes) of one call of ``entry`` on ``args``;
  peak(entry, args)  the operations a second its route runs at (roofline.py's
                PEAK_*), which with the HBM rate bounds the call.

A new family is one new file; no other file of the benchmark names it."""
