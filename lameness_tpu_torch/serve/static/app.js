// Core SPA runtime: API client, hash router, auth, shared widgets.
// The 20 pages under /static/pages/ mirror the reference frontend's
// src/pages/ set (admin-interface/frontend/src/pages/*.tsx) against the
// same REST/WS contract.

export let TOKEN = localStorage.getItem("token") || null;
export let USER = JSON.parse(localStorage.getItem("user") || "null");

export async function api(path, opts = {}) {
  opts.headers = Object.assign({}, opts.headers,
    TOKEN ? {Authorization: "Bearer " + TOKEN} : {});
  if (opts.json) {
    opts.method = opts.method || "POST";
    opts.body = JSON.stringify(opts.json);
    opts.headers["Content-Type"] = "application/json";
  }
  const r = await fetch(path, opts);
  if (r.status === 401) { showLogin(); throw new Error("unauthenticated"); }
  if (!r.ok) {
    let detail = r.statusText;
    try { detail = (await r.json()).detail || detail; } catch (e) {}
    throw new Error(detail);
  }
  return r.json();
}

export const h = (html) => {
  const d = document.createElement("div"); d.innerHTML = html; return d;
};
export const main = document.getElementById("main");
export const fmt = (x, d = 3) => x == null ? "—" : (+x).toFixed(d);
export const pct = (x) => x == null ? "—" : (100 * x).toFixed(1) + "%";
export const esc = (s) => String(s ?? "").replace(/[&<>"]/g,
  (c) => ({"&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;"}[c]));
export const short = (s, n = 8) => (s || "").slice(0, n);
export const when = (s) => (s || "").replace("T", " ").slice(0, 19);

export function toast(msg, cls = "") {
  const t = h(`<div class="toast ${cls}">${esc(msg)}</div>`);
  document.body.append(t);
  setTimeout(() => t.remove(), 3500);
}

// severity band colors (fusion-service severity bands .3/.5/.7)
export function sevClass(p) {
  return p == null ? "" : p >= 0.7 ? "bad" : p >= 0.5 ? "warn"
    : p >= 0.3 ? "warn" : "ok";
}
export function sevBadge(p) {
  const lbl = p == null ? "—" : p >= 0.7 ? "severe" : p >= 0.5 ? "moderate"
    : p >= 0.3 ? "mild" : "sound";
  return `<span class="badge ${sevClass(p)}">${lbl}</span>`;
}

// half-circle probability gauge
export function gauge(p, label = "") {
  const v = Math.max(0, Math.min(1, p ?? 0));
  const ang = Math.PI * (1 - v);
  const x = 60 + 52 * Math.cos(ang), y = 60 - 52 * Math.sin(ang);
  const large = v > 0.5 ? 1 : 0;
  const col = v >= 0.7 ? "var(--bad)" : v >= 0.4 ? "var(--warn)" : "var(--ok)";
  return `<div class="gauge"><svg width="120" height="66" viewBox="0 0 120 66">
    <path d="M 8 60 A 52 52 0 0 1 112 60" fill="none" stroke="var(--line)"
      stroke-width="9" stroke-linecap="round"/>
    <path d="M 8 60 A 52 52 0 ${large} 1 ${x.toFixed(1)} ${y.toFixed(1)}"
      fill="none" stroke="${col}" stroke-width="9" stroke-linecap="round"/>
    <text x="60" y="52" text-anchor="middle"
      style="font-size:16px;fill:var(--text);font-weight:600">${pct(p)}</text>
    <text x="60" y="64" text-anchor="middle">${esc(label)}</text></svg></div>`;
}

// inline svg sparkline/line chart
export function sparkline(values, {w = 260, h = 56, color = "var(--accent)",
                                   ymin = null, ymax = null} = {}) {
  if (!values || values.length === 0)
    return `<span class="dim">no data</span>`;
  const lo = ymin ?? Math.min(...values), hi = ymax ?? Math.max(...values);
  const span = Math.max(hi - lo, 1e-9);
  const pts = values.map((v, i) => {
    const x = values.length > 1 ? i / (values.length - 1) * (w - 8) + 4 : w / 2;
    const y = h - 6 - (v - lo) / span * (h - 12);
    return `${x.toFixed(1)},${y.toFixed(1)}`;
  }).join(" ");
  return `<svg width="${w}" height="${h}"><polyline points="${pts}"
    fill="none" stroke="${color}" stroke-width="2"/></svg>`;
}

// simple table builder: cols = [[header, render(row)]]
export function table(rows, cols, {rowAttr = null} = {}) {
  return `<table><tr>${cols.map(c => `<th>${c[0]}</th>`).join("")}</tr>
    ${rows.map(r => `<tr ${rowAttr ? rowAttr(r) : ""}>${
      cols.map(c => `<td>${c[1](r)}</td>`).join("")}</tr>`).join("")}</table>`;
}

// websocket channels (websocket/handler.py: pipeline/health/queue/rater).
// Client behavior mirrors hooks/useWebSocket.ts: bare "ping" every 25 s,
// bare "pong" filtered out, server {"type":"ping"} keepalives answered
// with "pong", reconnect up to 3 attempts 5 s apart.
let sockets = {};
let wsEpochs = {};   // bumped on new ws()/closeSockets: cancels stale reconnects
export function ws(channel, onEvent, reconnectAttempts = 3) {
  const epoch = (wsEpochs[channel] = (wsEpochs[channel] || 0) + 1);
  let tries = 0;
  const open = () => {
    if (wsEpochs[channel] !== epoch) return null;  // superseded by nav/new ws
    try {
      const old = sockets[channel];
      if (old) { try { old.onclose = null; old.close(); } catch (e) {} }
      const proto = location.protocol === "https:" ? "wss" : "ws";
      const s = new WebSocket(`${proto}://${location.host}/api/ws/${channel}`);
      let ping = null;
      s.onopen = () => {
        tries = 0;
        ping = setInterval(() => { try { s.send("ping"); } catch (e) {} },
                           25000);
      };
      s.onmessage = (ev) => {
        if (ev.data === "pong") return;
        try {
          const m = JSON.parse(ev.data);
          if (m.type === "ping") { try { s.send("pong"); } catch (e) {}
                                   return; }
          onEvent(m);
        } catch (e) {}
      };
      s.onclose = () => {
        clearInterval(ping);
        if (sockets[channel] === s && tries++ < reconnectAttempts)
          setTimeout(open, 5000);
      };
      sockets[channel] = s;
      return s;
    } catch (e) { return null; }
  };
  return open();
}
export function closeSockets() {
  Object.keys(wsEpochs).forEach(c => wsEpochs[c]++);
  Object.values(sockets).forEach(s => {
    try { s.onclose = null; s.close(); } catch (e) {}
  });
  sockets = {};
}

// ---------------------------------------------------------------------------
// router — pages mirror frontend/src/pages/*.tsx
// ---------------------------------------------------------------------------
const PAGES = {   // hash -> [module, label, hidden-from-nav]
  dashboard: ["dashboard", "Dashboard"],
  upload: ["video_upload", "Upload"],
  videos: ["video_results", "Videos"],
  analysis: ["video_analysis", "Analysis"],
  pairwise: ["pairwise_review", "Pairwise"],
  triplet: ["triplet_comparison", "Triplets"],
  hierarchy: ["hierarchy_visualization", "Hierarchy"],
  simmap: ["similarity_map", "Similarity"],
  cows: ["cow_list", "Cows"],
  cow: ["cow_detail", "Cow", true],
  pipeline: ["pipeline_monitor", "Pipeline"],
  pipelineanalysis: ["pipeline_analysis", "Perf"],
  health: ["system_health", "Health"],
  training: ["training_queue", "Training"],
  learn: ["training_module", "Learn"],
  tutorial: ["tutorial_management", "Tutorial"],
  mlconfig: ["ml_configuration", "ML Config"],
  users: ["user_management", "Users"],
  settings: ["settings", "Settings"],
};

export async function nav(page, ...params) {
  const entry = PAGES[page] || PAGES.dashboard;
  document.querySelectorAll("nav button").forEach(b =>
    b.classList.toggle("active", b.dataset.p === page));
  closeSockets();
  main.innerHTML = "<div class='dim'>loading…</div>";
  location.hash = [page, ...params].join("/");
  try {
    const mod = await import(`/static/pages/${entry[0]}.js`);
    main.innerHTML = "";
    await mod.default(...params);
  } catch (e) {
    if (e.message !== "unauthenticated")
      main.innerHTML = `<div class="panel bad">${esc(e.message)}</div>`;
  }
}
window.go = nav;          // pages use go('cow', id) for drill-downs

document.getElementById("nav").append(
  ...Object.entries(PAGES).filter(([, v]) => !v[2]).map(([p, v]) => {
    const b = document.createElement("button");
    b.textContent = v[1]; b.dataset.p = p; b.onclick = () => nav(p);
    return b;
  }));

// ---------------------------------------------------------------------------
// auth (Login.tsx)
// ---------------------------------------------------------------------------
export function showLogin() {
  main.innerHTML = "";
  main.append(h(`<div id="login" class="panel"><h2>Sign in</h2>
    <div class="row"><input id="u" placeholder="username" value="admin"></div>
    <div class="row"><input id="pw" type="password" placeholder="password"></div>
    <button class="action" id="go">Login</button>
    <p class="dim" style="margin-top:8px">initial passwords are printed
      to the server console at first startup</p></div>`));
  const submit = async () => {
    try {
      const r = await api("/api/auth/login", {json: {
        username: document.getElementById("u").value,
        password: document.getElementById("pw").value}});
      TOKEN = r.access_token; USER = r.user;
      localStorage.setItem("token", TOKEN);
      localStorage.setItem("user", JSON.stringify(USER));
      renderUser(); nav("dashboard");
    } catch (e) { toast(e.message, "bad"); }
  };
  document.getElementById("go").onclick = submit;
  document.getElementById("pw").onkeydown = (e) => {
    if (e.key === "Enter") submit();
  };
}

function renderUser() {
  document.getElementById("user").innerHTML = USER ?
    `${esc(USER.username)} <span class="badge">${esc(USER.role)}</span>
     <button class="mini" id="logout" style="margin-left:8px">out</button>` : "";
  const b = document.getElementById("logout");
  if (b) b.onclick = logout;
}
export function logout() {
  TOKEN = null; USER = null; localStorage.clear(); showLogin();
}

// theme (Settings.tsx)
const theme = localStorage.getItem("theme");
if (theme) document.documentElement.dataset.theme = theme;

renderUser();
if (!TOKEN) showLogin();
else {
  const parts = (location.hash.slice(1) || "dashboard").split("/");
  nav(parts[0], ...parts.slice(1));
}
