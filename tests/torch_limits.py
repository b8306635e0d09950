"""A time limit of its own for each test: ``@time_limit(seconds)`` fails
the test with ``TimeoutError`` once it has run that long (a SIGALRM timer
on the test's process: its main thread runs the test). No jax here."""
import functools
import signal


def time_limit(seconds: float):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            def expired(signum, frame):
                raise TimeoutError(f"{fn.__name__} ran past its limit of "
                                   f"{seconds} s")
            old = signal.signal(signal.SIGALRM, expired)
            signal.setitimer(signal.ITIMER_REAL, seconds)
            try:
                return fn(*a, **kw)
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, old)
        return wrapper
    return deco
