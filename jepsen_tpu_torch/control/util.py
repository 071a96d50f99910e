"""Remote scripting helpers: daemons, signals, archives.

Reference: jepsen/src/jepsen/control/util.clj — start-stop-daemon
pidfile management (:208-251), grepkill (:191-206), SIGSTOP/SIGCONT
(:266-270), cached archive install (:79-173).

The port's copy of jepsen_tpu.control.util;
tests/test_torch_db_control.py holds the two against each other.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

from jepsen_tpu_torch.control.core import RemoteError, Session


def start_daemon(
    session: Session,
    binary: str,
    *args,
    pidfile: str,
    logfile: str,
    chdir: Optional[str] = None,
    env: Optional[dict] = None,
) -> None:
    """Start a long-running process under a pidfile, stdout/stderr to
    logfile (start-daemon!, control/util.clj:208-236). Uses setsid +
    shell backgrounding rather than start-stop-daemon so it works on
    any POSIX host."""
    import shlex

    # Env rides through env(1): `setsid K=V prog` would execvp the
    # assignment string itself as the program.
    envs = (
        "env " + " ".join(
            f"{k}={shlex.quote(str(v))}" for k, v in env.items()
        ) + " "
        if env
        else ""
    )
    # Each argument shell-quoted: daemon args may carry spaces or
    # template braces (e.g. consul's go-sockaddr '-bind {{ GetPrivateIP }}').
    cmdline = envs + " ".join(
        [shlex.quote(binary), *[shlex.quote(str(a)) for a in args]]
    )
    script = (
        f"setsid {cmdline} >> {logfile} 2>&1 < /dev/null & "
        f"echo $! > {pidfile}"
    )
    session.exec("sh", "-c", script, cd=chdir)


def daemon_running(session: Session, pidfile: str) -> bool:
    """Is the pidfile's process alive? (daemon-running?,
    control/util.clj:253-264)"""
    try:
        out = session.exec(
            "sh", "-c", f"test -f {pidfile} && kill -0 $(cat {pidfile})"
        )
        return True
    except RemoteError:
        return False


def stop_daemon(session: Session, pidfile: str,
                signal: str = "TERM") -> None:
    """Kill the pidfile's process and remove the pidfile
    (stop-daemon!, control/util.clj:238-251)."""
    session.exec(
        "sh", "-c",
        f"test -f {pidfile} && kill -{signal} $(cat {pidfile}) || true; "
        f"rm -f {pidfile}",
    )


def grepkill(session: Session, pattern: str, signal: str = "KILL") -> None:
    """Kill processes matching a pattern (grepkill!,
    control/util.clj:191-206)."""
    session.exec("pkill", f"-{signal}", "-f", pattern, check=False)


def signal_proc(session: Session, process: str, signal: str) -> None:
    """Send a signal by process name — SIGSTOP/SIGCONT for pause
    nemeses (signal!, control/util.clj:266-270). killall (psmisc) with
    a pkill fallback: minimal images often ship procps only."""
    import shlex

    # The cmdline fallback covers interpreter-run daemons (python/
    # java), whose program name lives in argv, not comm. It must NOT
    # use bare `pkill -f`: the pattern appears inside this very shell
    # wrapper's cmdline, and a self-SIGSTOP wedges the control session
    # forever. Instead, walk pgrep's candidates and signal only
    # non-shell processes (the daemon's comm is its interpreter).
    sig = shlex.quote(str(signal))
    proc = shlex.quote(process)
    fallback = (
        f'for p in $(pgrep -f {proc}); do '
        f'c=$(cat /proc/$p/comm 2>/dev/null); '
        f'case "$c" in sh|bash|dash|sudo|pgrep|pkill|killall) ;; '
        f'*) kill -{sig} $p ;; esac; done'
    )
    session.exec(
        "sh", "-c",
        f"killall -s {sig} {proc} 2>/dev/null || "
        f"pkill -{sig} -x {proc} 2>/dev/null || {{ {fallback}; }}",
        sudo=True,
    )


def install_archive(
    session: Session,
    url: str,
    dest_dir: str,
    cache_dir: str = "/tmp/jepsen/cache",
) -> None:
    """Download (once — URL-keyed cache) and untar an archive into
    dest_dir (install-archive!/cached-wget!, control/util.clj:79-173).
    Retries a corrupt cached archive by re-downloading."""
    key = hashlib.sha256(url.encode()).hexdigest()[:24]
    cached = f"{cache_dir}/{key}.tar"
    session.exec("mkdir", "-p", cache_dir, dest_dir)
    session.exec(
        "sh", "-c",
        f"test -f {cached} || wget -q -O {cached} {url}",
    )
    try:
        session.exec("tar", "-xf", cached, "-C", dest_dir)
    except RemoteError:
        # Corrupt cache: re-fetch once (control/util.clj:150-167).
        session.exec("rm", "-f", cached)
        session.exec("wget", "-q", "-O", cached, url)
        session.exec("tar", "-xf", cached, "-C", dest_dir)
