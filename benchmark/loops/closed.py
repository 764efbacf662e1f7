"""Closed loop of one client: the next call goes out when the last one has
returned, as a user's `easy-search` does; calls until the window's seconds
have passed (a call that straddles the end is waited for; `Window.running`)."""


def drive(window, traffic, seconds):
    if traffic["clients"] != 1:
        raise ValueError("the closed loop drives one client")
    c = 0
    while window.running(seconds):
        window.call(c)
        c += 1
