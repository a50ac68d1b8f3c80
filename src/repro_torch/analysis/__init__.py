"""Runtime checks of the port.

- ``compile_guard``  no capture of a slot-path step after ``warmup()``
                     (``CompileGuard``, ``SteadyStateRecompile``)
"""
