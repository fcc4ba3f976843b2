"""The harness's shared yardstick: nothing here reads the program's
own arithmetic, so a change to the port cannot move it."""
