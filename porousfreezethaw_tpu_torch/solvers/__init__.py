from .merson import MersonParams, MersonState, merson_solve, merson_init
