"""How each mode of ``wgbench/modes`` is run and read inside the port's
``utils.perf.Timeline``: ``timelines/<mode>.py`` gives ``unit(mode)``, the
unit of work traced and its name, and ``reading(mode, perf, device)``, the
reading that the ``program_span`` metrics of the mode's cells take apart
(``metrics/_timeline.py``). A mode with no file here has no such metrics."""
