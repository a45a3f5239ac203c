"""CLI entry: `python -m openwebrx_tpu_torch [admin …]`.

Reference: ``owrx/__main__.py:51-91`` + ``owrx/admin/`` — serve by
default (every argument goes to ``web.server``: ``--device``, ``--port``,
``--signal-demo``, ``--sdrs``, ``--help``); `admin adduser/removeuser/
resetpassword/listusers/enable/disable/hasuser` manage the web-admin user
store.
"""

from __future__ import annotations

import argparse
import getpass
import sys


def _admin(args) -> int:
    from openwebrx_tpu_torch.core.users import UserList

    users = UserList.shared()
    cmd = args.admin_command
    if cmd == "listusers":
        for user in users.values():
            flag = "" if user.enabled else " (disabled)"
            print(f"  {user.name}{flag}")
        return 0
    if cmd == "hasuser":
        present = args.username in users
        print(f"user {args.username} {'exists' if present else 'does not exist'}")
        return 0 if present else 1
    if cmd == "adduser":
        password = args.password or getpass.getpass(f"password for {args.username}: ")
        users.add_user(args.username, password)
        print(f"added user {args.username}")
        return 0
    if cmd == "removeuser":
        users.delete_user(args.username)
        print(f"removed user {args.username}")
        return 0
    if cmd == "resetpassword":
        password = args.password or getpass.getpass(f"new password for {args.username}: ")
        users.set_password(args.username, password, must_change=False)
        print(f"password reset for {args.username}")
        return 0
    if cmd in ("enable", "disable"):
        users.set_enabled(args.username, cmd == "enable")
        print(f"{cmd}d user {args.username}")
        return 0
    print(f"unknown admin command {cmd}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="openwebrx_tpu_torch",
                                     description="web SDR receiver on PyTorch")
    sub = parser.add_subparsers(dest="command")
    admin = sub.add_parser("admin", help="manage web admin users")
    admin_sub = admin.add_subparsers(dest="admin_command", required=True)
    for name, needs_user in (("adduser", True), ("removeuser", True),
                             ("resetpassword", True), ("enable", True),
                             ("disable", True), ("hasuser", True),
                             ("listusers", False)):
        p = admin_sub.add_parser(name)
        if needs_user:
            p.add_argument("username")
            if name in ("adduser", "resetpassword"):
                p.add_argument("--password", default=None,
                               help="non-interactive password (avoid in shells)")
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["admin"]:
        return _admin(parser.parse_args(argv))
    # default: run the web receiver with every argument (an option's value,
    # as in --port 8073 or --device cpu, is never taken for a subcommand)
    from openwebrx_tpu_torch.web.server import main as server_main
    server_main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
