"""One file per hand-written kernel of the program: the module and function
that launch it (``MODULE``, ``FUNCTION``), and ``bound(args, out)``, the
seconds one call needs at least (``work.py``). The harness wraps every
function listed here in a profiler range while a traced run records, so a
kernel added to the program is counted by adding its file."""
