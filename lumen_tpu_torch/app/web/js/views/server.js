// Server view (reference: web-ui/src/views/Server + SessionHub): start /
// stop / restart the supervised gRPC hub, watch health + live logs.

import { api, logStream } from "../api.js";
import { wizard } from "../wizard.js";
import { el, toast, attachLogPane, logLine } from "../ui.js";

let pollTimer = null;

export function renderServer(root, onLeave) {
  root.append(
    el("h2", { class: "view-title" }, "Server"),
    el("p", { class: "view-sub" }, "The gRPC hub runs as a supervised subprocess of this control plane."),
    el("div", { class: "grid2" }, [
      el("div", { class: "card" }, [
        el("h3", {}, "Status"),
        el("dl", { class: "kv", id: "srv-kv" }, []),
        el("div", { class: "row", style: "margin-top:12px" }, [
          el("button", { class: "btn primary", id: "srv-start" }, "Start"),
          el("button", { class: "btn", id: "srv-restart" }, "Restart"),
          el("button", { class: "btn danger", id: "srv-stop" }, "Stop"),
        ]),
        el("p", { class: "muted", id: "srv-msg" }),
      ]),
      el("div", { class: "card" }, [
        el("h3", {}, "Serving metrics"),
        el("pre", { class: "code", id: "srv-metrics", style: "max-height:220px" }, "—"),
        el("button", { class: "btn small", id: "srv-metrics-refresh", style: "margin-top:8px" }, "Refresh metrics"),
      ]),
    ]),
    el("div", { class: "card" }, [
      el("h3", {}, "Live logs"),
      el("div", { class: "logpane", id: "srv-logs" }),
    ])
  );

  const logPane = root.querySelector("#srv-logs");
  const unsubLogs = attachLogPane(logPane, logStream);
  // Backfill: the WS stream only carries lines from after this view
  // connected; GET /server/logs serves the earlier history.
  api
    .serverLogs()
    .then((out) => {
      for (const line of (out.lines || []).reverse()) {
        logPane.prepend(logLine({ message: line.message }));
      }
    })
    .catch(() => {});
  onLeave(() => {
    unsubLogs();
    clearTimeout(pollTimer);
  });

  const act = (fn, label) => async () => {
    try {
      await fn();
      toast(label);
      refresh(root);
    } catch (e) {
      toast(e.message, true);
    }
  };
  root.querySelector("#srv-start").onclick = act(
    () =>
      api.serverStart({
        ...(wizard.state.configPath ? { config_path: wizard.state.configPath } : {}),
        // OS-assigned metrics port: without it ServerManager never learns
        // a metrics address and the metrics panel stays empty forever.
        extra_args: ["--metrics-port", "0"],
      }),
    "server starting"
  );
  root.querySelector("#srv-stop").onclick = act(() => api.serverStop(), "server stopped");
  root.querySelector("#srv-restart").onclick = act(() => api.serverRestart(), "server restarting");
  root.querySelector("#srv-metrics-refresh").onclick = () => loadMetrics(root);

  refresh(root);
}

async function refresh(root) {
  if (!root.isConnected) return;
  // One poll chain only: a button-triggered refresh replaces the pending
  // tick instead of stacking a second chain.
  clearTimeout(pollTimer);
  let info;
  try {
    info = await api.serverStatus();
  } catch (e) {
    root.querySelector("#srv-msg").textContent = e.message;
    pollTimer = setTimeout(() => refresh(root), 3000);
    return;
  }
  const kvEl = root.querySelector("#srv-kv");
  kvEl.replaceChildren(
    ...kv("state", badgeFor(info)),
    ...kv("healthy", String(info.healthy)),
    ...kv("pid", info.pid ?? "—"),
    ...kv("config", info.config_path ?? wizard.state.configPath ?? "—"),
    ...kv("gRPC port", info.port ?? "—"),
    ...kv("metrics port", info.metrics_port ?? "—"),
    ...kv("uptime", info.uptime_s != null ? `${Math.round(info.uptime_s)}s` : "—")
  );
  const live = info.status === "running" || info.status === "starting";
  const crashed = info.status === "failed";
  // Crash recovery (reference Server view's failure states): say what
  // happened (exit code) and leave BOTH recovery paths enabled — Restart
  // relaunches with the same config, Start allows picking a new one.
  const msg = root.querySelector("#srv-msg");
  if (crashed) {
    msg.textContent =
      `server exited unexpectedly (exit code ${info.exit_code ?? "?"}) — ` +
      "see the logs below, then Restart to relaunch with the same config.";
    msg.classList.add("err-note");
  } else {
    // #srv-msg only ever carries transient notices (fetch errors, the
    // crash banner) — a successful status poll clears it outright.
    msg.textContent = "";
    msg.classList.remove("err-note");
  }
  root.querySelector("#srv-start").disabled = live;
  root.querySelector("#srv-stop").disabled = !live;
  root.querySelector("#srv-restart").disabled = !(live || crashed);
  pollTimer = setTimeout(() => refresh(root), 2500);
}

async function loadMetrics(root) {
  try {
    const text = await api.metrics();
    root.querySelector("#srv-metrics").textContent = text || "(no metrics yet)";
  } catch (e) {
    root.querySelector("#srv-metrics").textContent = e.message;
  }
}

function badgeFor(info) {
  if (info.status === "running" && info.healthy) return el("span", { class: "badge ok" }, "running");
  if (info.status === "running") return el("span", { class: "badge warn" }, "running (unhealthy)");
  if (info.status === "starting") return el("span", { class: "badge warn" }, "starting");
  if (info.status === "failed") return el("span", { class: "badge err" }, "failed");
  return el("span", { class: "badge" }, "stopped");
}

function kv(k, v) {
  return [el("dt", {}, k), el("dd", {}, v instanceof Node ? v : String(v))];
}
