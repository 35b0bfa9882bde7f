"""Drivers: one for each kind of traffic a mix file can name
(``"driver"``). A driver sets up the program from the configuration, runs
the mix's traffic through the program's own entry points for the window,
and checks what the window produced against the reference."""
